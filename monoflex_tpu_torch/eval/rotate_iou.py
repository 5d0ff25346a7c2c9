"""Rotated rectangle overlap for the KITTI evaluator (host side, numpy).

Replaces the reference's numba-CUDA polygon-clipping kernel
(reference: data/datasets/evaluation/kitti_object_eval_python/rotate_iou.py:18-333)
with a numpy Sutherland-Hodgman implementation plus an axis-aligned bounds
prefilter.  The JAX package can swap in a C++ version with the same
semantics; the port has only this one.

Box format: (cx, cy, w, h, angle) in an arbitrary consistent 2-D frame (the
evaluator passes (x, z, l, w, ry) camera-BEV boxes).
Criterion: -1 -> IoU, 0 -> inter/area_box, 1 -> inter/area_query,
2 -> raw intersection area (used by the 3D metric).
"""

from __future__ import annotations

import numpy as np


def box_corners(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) -> (N, 4, 2) corner coordinates.

    The angle rotates CLOCKWISE in the (x, y) plane: KITTI's ry is a rotation
    about the camera y-axis, which acts on the BEV (x, z) plane as
    x' = x cos + z sin, z' = -x sin + z cos (reference
    kitti_object_eval_python/rotate_iou.py:210-234 rbbox_to_corners).  With
    offset centers and differing angles the opposite convention yields a
    genuinely different overlap, not a mirror image (round-2 parity harness
    caught exactly that)."""
    cx, cy, w, h, ang = boxes.T
    c, s = np.cos(ang), np.sin(ang)
    dx = np.stack([-w / 2, w / 2, w / 2, -w / 2], axis=1)
    dy = np.stack([-h / 2, -h / 2, h / 2, h / 2], axis=1)
    x = cx[:, None] + c[:, None] * dx + s[:, None] * dy
    y = cy[:, None] - s[:, None] * dx + c[:, None] * dy
    return np.stack([x, y], axis=2)


def _polygon_area(pts: np.ndarray) -> float:
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y)))


def _clip_polygon(subject: np.ndarray, clip_quad: np.ndarray) -> np.ndarray:
    """Clip a convex polygon by a convex quad (CCW). Returns vertex array."""
    # ensure CCW winding of the clip polygon
    if _signed_area(clip_quad) < 0:
        clip_quad = clip_quad[::-1]
    output = subject
    for i in range(4):
        if len(output) == 0:
            return output
        a = clip_quad[i]
        b = clip_quad[(i + 1) % 4]
        edge = b - a
        d = output - a
        side = edge[0] * d[:, 1] - edge[1] * d[:, 0]
        new_pts = []
        n = len(output)
        for j in range(n):
            k = (j + 1) % n
            cur_in = side[j] >= 0
            nxt_in = side[k] >= 0
            if cur_in:
                new_pts.append(output[j])
            if cur_in != nxt_in:
                denom = side[j] - side[k]
                t = side[j] / denom if denom != 0 else 0.0
                new_pts.append(output[j] + (output[k] - output[j]) * t)
        output = np.asarray(new_pts).reshape(-1, 2)
    return output


def _signed_area(pts: np.ndarray) -> float:
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))


def rotate_iou_eval(boxes: np.ndarray, qboxes: np.ndarray,
                    criterion: int = -1) -> np.ndarray:
    """Pairwise rotated overlap (N, K) with the reference's criterion codes."""
    boxes = np.asarray(boxes, dtype=np.float64)
    qboxes = np.asarray(qboxes, dtype=np.float64)
    N, K = boxes.shape[0], qboxes.shape[0]
    out = np.zeros((N, K), dtype=np.float64)
    if N == 0 or K == 0:
        return out

    corners_a = box_corners(boxes)
    corners_b = box_corners(qboxes)
    # axis-aligned prefilter
    amin, amax = corners_a.min(axis=1), corners_a.max(axis=1)
    bmin, bmax = corners_b.min(axis=1), corners_b.max(axis=1)
    possible = ~((amax[:, None, 0] < bmin[None, :, 0])
                 | (bmax[None, :, 0] < amin[:, None, 0])
                 | (amax[:, None, 1] < bmin[None, :, 1])
                 | (bmax[None, :, 1] < amin[:, None, 1]))

    area_a = boxes[:, 2] * boxes[:, 3]
    area_b = qboxes[:, 2] * qboxes[:, 3]
    for n in range(N):
        for k in np.nonzero(possible[n])[0]:
            inter_poly = _clip_polygon(corners_a[n], corners_b[k])
            if len(inter_poly) < 3:
                continue
            inter = _polygon_area(inter_poly)
            if criterion == -1:
                denom = area_a[n] + area_b[k] - inter
            elif criterion == 0:
                denom = area_a[n]
            elif criterion == 1:
                denom = area_b[k]
            else:
                out[n, k] = inter
                continue
            out[n, k] = inter / denom if denom > 0 else 0.0
    return out


def d3_box_overlap(boxes: np.ndarray, qboxes: np.ndarray,
                   criterion: int = -1) -> np.ndarray:
    """3D overlap in camera coords: boxes (N, 7) [x y z l h w ry]; BEV
    intersection x height overlap (y is the bottom face, height extends up,
    i.e. towards smaller y)
    (reference: kitti_object_eval_python/eval.py:119-152)."""
    rinc = rotate_iou_eval(boxes[:, [0, 2, 3, 5, 6]], qboxes[:, [0, 2, 3, 5, 6]], 2)
    N, K = rinc.shape
    out = np.zeros_like(rinc)
    for i in range(N):
        for j in range(K):
            if rinc[i, j] <= 0:
                continue
            iw = (min(boxes[i, 1], qboxes[j, 1])
                  - max(boxes[i, 1] - boxes[i, 4], qboxes[j, 1] - qboxes[j, 4]))
            if iw <= 0:
                continue
            vol_a = boxes[i, 3] * boxes[i, 4] * boxes[i, 5]
            vol_b = qboxes[j, 3] * qboxes[j, 4] * qboxes[j, 5]
            inc = iw * rinc[i, j]
            if criterion == -1:
                denom = vol_a + vol_b - inc
            elif criterion == 0:
                denom = vol_a
            elif criterion == 1:
                denom = vol_b
            else:
                out[i, j] = inc
                continue
            out[i, j] = inc / denom if denom > 0 else 0.0
    return out


def image_box_overlap(boxes: np.ndarray, query_boxes: np.ndarray,
                      criterion: int = -1) -> np.ndarray:
    """Axis-aligned 2D box overlap, vectorized
    (reference: kitti_object_eval_python/eval.py:84-113)."""
    boxes = np.asarray(boxes, dtype=np.float64)
    query_boxes = np.asarray(query_boxes, dtype=np.float64)
    N, K = boxes.shape[0], query_boxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K), dtype=np.float64)
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    inter[(iw <= 0) | (ih <= 0)] = 0
    area_b = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        denom = area_b + area_q - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_b, inter.shape).copy()
    elif criterion == 1:
        denom = np.broadcast_to(area_q, inter.shape).copy()
    else:
        return inter
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(denom > 0, inter / denom, 0.0)
    return out
