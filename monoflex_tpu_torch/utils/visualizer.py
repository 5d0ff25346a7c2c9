"""Prediction visualization, drawn with Pillow (counterpart of
``monoflex_tpu/utils/visualizer.py``, which draws with matplotlib).

The same overlays as the JAX figure (reference: engine/visualize_infer.py:
148-247): an image panel with the predicted (class-coloured) and
ground-truth (red) 2D boxes, projected 3D wireframes, keypoints and labels;
a bird's-eye panel (x in [-40, 40] m, z in [0, 80] m) with the predicted and
ground-truth footprints; and the predicted heatmap (its maximum over the
classes).  The geometry is numpy and follows the JAX functions
(``gt_corners``, ``projected_corners``, ``bev_corners``); the tests hold
them to the JAX module.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..config import ID_TYPE_CONVERSION
from ..core.geometry_np import Calibration, box3d_corners

# matplotlib's tab10 colours, by the JAX figure's names
TAB = {"blue": (31, 119, 180), "orange": (255, 127, 14), "green": (44, 160, 44),
       "red": (214, 39, 40), "purple": (148, 103, 189), "brown": (140, 86, 75),
       "pink": (227, 119, 194), "gray": (127, 127, 127), "olive": (188, 189, 34),
       "cyan": (23, 190, 207)}
CLASS_COLORS = {0: TAB["green"], 1: TAB["cyan"], 2: TAB["olive"]}
GT_COLOR = TAB["red"]
# the 8 corners and the bottom / top centres (reference visualize_infer.py)
KEYPOINT_COLORS = [TAB[k] for k in ("blue", "orange", "green", "red", "purple", "brown", "pink",
                                    "gray", "olive", "cyan")]
# wireframe edges over the 8-corner box (bottom 0-3, top 4-7)
BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
# the bird's-eye panel's extent in metres and its size in pixels
BEV_X = (-40.0, 40.0)
BEV_Z = (0.0, 80.0)
# viridis at 0, 1/4, 1/2, 3/4 and 1, interpolated linearly between
_VIRIDIS = np.array([(68, 1, 84), (59, 82, 139), (33, 145, 140), (94, 201, 98),
                     (253, 231, 37)], np.float64)


def gt_corners(dims_lhw: np.ndarray, loc: np.ndarray, roty: float) -> np.ndarray:
    """Ground-truth 3D corners from the encoded (l, h, w) dims and the 3D
    centre (the target encoder lifts KITTI's bottom centres by h/2;
    box3d_corners wants the bottom centre back, as the reference's
    visualize_infer.py:216-234 does)."""
    l, h, w = dims_lhw
    bottom = np.asarray(loc, dtype=np.float64).copy()
    bottom[1] += h / 2.0
    return box3d_corners(np.array([l, h, w]), bottom, float(roty))


def predicted_corners(row: np.ndarray) -> np.ndarray:
    """The 3D corners of a decoded row [cls alpha box2d(4) hwl xyz ry score]."""
    h, w, l = row[6:9]
    return box3d_corners(np.array([l, h, w]), row[9:12], float(row[12]))


def projected_corners(calib: Calibration, corners: np.ndarray):
    """(uv (8, 2), depth (8,)) of the corners on the image."""
    return calib.project_rect_to_image(corners)


def bev_corners(corners_3d: np.ndarray) -> np.ndarray:
    """The footprint (x, z) of the bottom face, (4, 2)."""
    return corners_3d[:4][:, [0, 2]]


def keypoints_on_image(keypoints: np.ndarray, center: np.ndarray, down_ratio: int,
                       pad: np.ndarray) -> np.ndarray:
    """Feature-map keypoint offsets relative to the predicted centre, as
    pixels of the unpadded image."""
    return (np.asarray(keypoints) + np.asarray(center)[None]) * down_ratio - pad[None]


def heatmap_rgb(heatmap: np.ndarray) -> np.ndarray:
    """The heatmap's maximum over classes (C, H, W) as a viridis RGB image,
    scaled from its minimum to its maximum."""
    m = np.asarray(heatmap, np.float64).max(axis=0)
    t = (m - m.min()) / max(m.max() - m.min(), 1e-12) * (len(_VIRIDIS) - 1)
    i = np.clip(np.floor(t).astype(int), 0, len(_VIRIDIS) - 2)
    f = (t - i)[..., None]
    return ((1 - f) * _VIRIDIS[i] + f * _VIRIDIS[i + 1]).astype(np.uint8)


def _image_uint8(image: np.ndarray) -> np.ndarray:
    """An HWC image as uint8, a float one scaled from its minimum to its
    maximum."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        lo, hi = img.min(), img.max()
        img = ((img - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)
    return img


def show_image_with_boxes(image: np.ndarray, results: np.ndarray, valid: np.ndarray,
                          calib: Calibration, score_threshold: float = 0.4,
                          heatmap: Optional[np.ndarray] = None,
                          targets: Optional[Dict[str, np.ndarray]] = None,
                          keypoints: Optional[np.ndarray] = None,
                          centers: Optional[np.ndarray] = None,
                          pad_size: Optional[np.ndarray] = None, down_ratio: int = 4,
                          save_path: Optional[str] = None):
    """Render one image's detections beside its ground truth; returns the
    PIL image and writes it as a PNG to ``save_path`` when given.

    results: (K, 14) decode rows; valid: (K,) bool.  targets: the image's
    encoded ground truth (reg_mask, gt_bboxes, dimensions (l, h, w),
    locations, rotys).  keypoints: (K, 10, 2) feature-map offsets from the
    predicted centres (K, 2).  heatmap: (C, H, W)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(_image_uint8(image)).convert("RGB")
    width, height = img.size
    bev_px = height                       # a square panel as tall as the image
    heat = None
    if heatmap is not None:
        heat = Image.fromarray(heatmap_rgb(heatmap))
        heat = heat.resize((max(1, round(heat.width * height / heat.height)), height))
    title = 14
    canvas = Image.new("RGB", (width + bev_px + (heat.width if heat else 0), height + title),
                       "white")
    canvas.paste(img, (0, title))
    if heat is not None:
        canvas.paste(heat, (width + bev_px, title))
    draw = ImageDraw.Draw(canvas)

    def img_line(points, color, lw):
        draw.line([(float(u), float(v) + title) for u, v in points], fill=color, width=lw)

    def box2d(box, color, lw):
        x1, y1, x2, y2 = (float(v) for v in box)
        img_line([(x1, y1), (x2, y1), (x2, y2), (x1, y2), (x1, y1)], color, lw)

    def wireframe(uv, color, lw):
        for i, j in BOX_EDGES:
            img_line([uv[i], uv[j]], color, lw)

    # the bird's-eye panel: x to the right, z up
    x0 = width

    def bev_xy(pts):
        sx = (pts[:, 0] - BEV_X[0]) / (BEV_X[1] - BEV_X[0]) * (bev_px - 1) + x0
        sy = (1 - (pts[:, 1] - BEV_Z[0]) / (BEV_Z[1] - BEV_Z[0])) * (bev_px - 1) + title
        return [(float(a), float(b)) for a, b in zip(sx, sy)]

    for z in range(int(BEV_Z[0]), int(BEV_Z[1]) + 1, 10):
        draw.line(bev_xy(np.array([[BEV_X[0], z], [BEV_X[1], z]])), fill=(230, 230, 230))
    for x in range(int(BEV_X[0]), int(BEV_X[1]) + 1, 10):
        draw.line(bev_xy(np.array([[x, BEV_Z[0]], [x, BEV_Z[1]]])), fill=(230, 230, 230))

    def footprint(corners, color, lw):
        bev = bev_corners(corners)
        draw.line(bev_xy(np.vstack([bev, bev[:1]])), fill=color, width=lw)

    pad = np.zeros(2) if pad_size is None else np.asarray(pad_size, np.float64)
    n_pred = 0
    for k, (row, ok) in enumerate(zip(results, valid)):
        if not ok or row[13] < score_threshold:
            continue
        n_pred += 1
        cls_id = int(row[0])
        color = CLASS_COLORS.get(cls_id, TAB["red"])
        box2d(row[2:6], color, 2)
        corners = predicted_corners(row)
        uv, depth = projected_corners(calib, corners)
        if (depth > 0).all():
            wireframe(uv, color, 2)
        footprint(corners, color, 2)
        name = ID_TYPE_CONVERSION.get(cls_id, "?")
        draw.text((float(row[2]), float(row[3]) - 12 + title), f"{name} {row[13]:.2f}",
                  fill=color)
        if keypoints is not None and centers is not None:
            kp = keypoints_on_image(keypoints[k], centers[k], down_ratio, pad)
            for j, (u, v) in enumerate(kp):
                v = v + title
                draw.ellipse([u - 2, v - 2, u + 2, v + 2],
                             fill=KEYPOINT_COLORS[j % len(KEYPOINT_COLORS)])

    caption = f"detections: {n_pred}"
    if targets is not None:
        mask = np.asarray(targets["reg_mask"]).astype(bool)
        for i in np.nonzero(mask)[0]:
            box2d(np.asarray(targets["gt_bboxes"][i]), GT_COLOR, 1)
            corners = gt_corners(np.asarray(targets["dimensions"][i]),
                                 np.asarray(targets["locations"][i]), float(targets["rotys"][i]))
            uv, depth = projected_corners(calib, corners)
            if (depth > 0).all():
                wireframe(uv, GT_COLOR, 1)
            footprint(corners, GT_COLOR, 1)
        caption = f"detections / gt objs: {n_pred} / {int(mask.sum())}"
    draw.text((2, 1), caption, fill=(0, 0, 0))
    draw.text((x0 + 2, 1), "BEV", fill=(0, 0, 0))
    if heat is not None:
        draw.text((width + bev_px + 2, 1), "heatmap", fill=(0, 0, 0))
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        canvas.save(save_path)
    return canvas


def show_heatmap(heatmap: np.ndarray, save_path: Optional[str] = None):
    """The heatmap's maximum over classes (C, H, W), viridis, as a PIL image."""
    from PIL import Image

    out = Image.fromarray(heatmap_rgb(heatmap))
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        out.save(save_path)
    return out
