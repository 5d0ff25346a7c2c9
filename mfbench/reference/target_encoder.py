"""Per-image training-target encoding (host side, numpy).

Re-derivation of the reference's dataset ``__getitem__`` target construction
(reference: data/datasets/kitti.py:230-525): for each labelled object project
the 3D center and 10 keypoints, handle truncated objects with a border
intersection center, splat class heatmaps, and fill fixed-shape arrays.

Everything is fixed shape (MAX_OBJECTS rows + masks, MAX_EDGE boundary pixels
+ a length) so batches stack into fixed-shape tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .config import TYPE_ID_CONVERSION
from .geometry_np import Calibration, approx_proj_center, encode_alpha_multibin
from .heatmap import draw_ellip_gaussian, draw_gaussian, gaussian_radius
from .kitti_objects import Object3d


@dataclass
class EncoderSpec:
    """The subset of config the target encoder needs."""

    num_classes: int = 3
    input_width: int = 1280
    input_height: int = 384
    down_ratio: int = 4
    max_objs: int = 40
    orientation_bins: int = 4
    consider_outside_objs: bool = True
    proj_center_mode: str = "intersect"
    filter_annos: bool = True
    filter_params: Sequence[float] = (0.9, 20)
    adjust_edge_heatmap: bool = True
    edge_heatmap_ratio: float = 0.5
    heatmap_center: str = "3D"
    keypoint_visible_modify: bool = True
    enable_edge_fusion: bool = True

    @property
    def output_width(self) -> int:
        return self.input_width // self.down_ratio

    @property
    def output_height(self) -> int:
        return self.input_height // self.down_ratio

    @property
    def max_edge_length(self) -> int:
        return (self.output_width + self.output_height) * 2

    @classmethod
    def from_cfg(cls, cfg, is_train: bool = True) -> "EncoderSpec":
        return cls(
            num_classes=len(cfg.DATASETS.DETECT_CLASSES),
            input_width=cfg.INPUT.WIDTH_TRAIN if is_train else cfg.INPUT.WIDTH_TEST,
            input_height=cfg.INPUT.HEIGHT_TRAIN if is_train else cfg.INPUT.HEIGHT_TEST,
            down_ratio=cfg.MODEL.BACKBONE.DOWN_RATIO,
            max_objs=cfg.DATASETS.MAX_OBJECTS,
            orientation_bins=cfg.INPUT.ORIENTATION_BIN_SIZE,
            consider_outside_objs=cfg.DATASETS.CONSIDER_OUTSIDE_OBJS,
            proj_center_mode=cfg.INPUT.APPROX_3D_CENTER,
            filter_annos=cfg.DATASETS.FILTER_ANNO_ENABLE,
            filter_params=tuple(cfg.DATASETS.FILTER_ANNOS),
            adjust_edge_heatmap=cfg.INPUT.ADJUST_BOUNDARY_HEATMAP,
            edge_heatmap_ratio=cfg.INPUT.HEATMAP_RATIO,
            heatmap_center=cfg.INPUT.HEATMAP_CENTER,
            keypoint_visible_modify=cfg.INPUT.KEYPOINT_VISIBLE_MODIFY,
            enable_edge_fusion=cfg.MODEL.HEAD.ENABLE_EDGE_FUSION,
        )


def pad_image(img: np.ndarray, spec: EncoderSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Center-pad HWC uint8/float image to the fixed input size
    (reference: data/datasets/kitti.py:218-228)."""
    h, w, c = img.shape
    out = np.zeros((spec.input_height, spec.input_width, c), dtype=img.dtype)
    pad_y = (spec.input_height - h) // 2
    pad_x = (spec.input_width - w) // 2
    out[pad_y: pad_y + h, pad_x: pad_x + w] = img
    return out, np.array([pad_x, pad_y], dtype=np.int64)


def compute_edge_indices(img_size: Tuple[int, int], pad_size: np.ndarray,
                         spec: EncoderSpec) -> np.ndarray:
    """Chain of feature-map boundary pixels of the un-padded image region,
    walked left->bottom->right->top (reference: data/datasets/kitti.py:126-179).

    Returns (K, 2) int64 [x, y] rows.
    """
    img_w, img_h = img_size
    dr = spec.down_ratio
    x_min = int(np.ceil(pad_size[0] / dr))
    y_min = int(np.ceil(pad_size[1] / dr))
    x_max = int((pad_size[0] + img_w - 1) // dr)
    y_max = int((pad_size[1] + img_h - 1) // dr)

    segments = []
    # left edge, top -> bottom (excludes y_max)
    ys = np.arange(y_min, y_max)
    segments.append(np.stack([np.full_like(ys, x_min), ys], axis=1))
    # bottom edge, left -> right (excludes x_max)
    xs = np.arange(x_min, x_max)
    segments.append(np.stack([xs, np.full_like(xs, y_max)], axis=1))
    # right edge, bottom -> top (excludes y_min)
    ys = np.arange(y_max, y_min, -1)
    segments.append(np.stack([np.full_like(ys, x_max), ys], axis=1))
    # top edge, right -> left (includes x_min)
    xs = np.arange(x_max, x_min - 1, -1)
    segments.append(np.stack([xs, np.full_like(xs, y_min)], axis=1))
    return np.concatenate(segments, axis=0).astype(np.int64)


def encode_targets(objs: Optional[List[Object3d]], calib: Calibration,
                   img_size: Tuple[int, int], pad_size: np.ndarray,
                   spec: EncoderSpec) -> Dict[str, np.ndarray]:
    """Build the full fixed-shape target dict for one (already augmented,
    pre-padding-size) image.

    ``img_size`` is the un-padded (w, h). All output coordinates live in the
    down-sampled feature map frame.
    """
    img_w, img_h = img_size
    out_w, out_h = spec.output_width, spec.output_height
    m = spec.max_objs

    t: Dict[str, np.ndarray] = {
        "hm": np.zeros((out_h, out_w, spec.num_classes), dtype=np.float32),
        "cls_ids": np.zeros(m, dtype=np.int32),
        "target_centers": np.zeros((m, 2), dtype=np.int32),
        "2d_bboxes": np.zeros((m, 4), dtype=np.float32),
        "gt_bboxes": np.zeros((m, 4), dtype=np.float32),
        "keypoints": np.zeros((m, 10, 3), dtype=np.float32),
        "keypoints_depth_mask": np.zeros((m, 3), dtype=np.float32),
        "dimensions": np.zeros((m, 3), dtype=np.float32),
        "locations": np.zeros((m, 3), dtype=np.float32),
        "rotys": np.zeros(m, dtype=np.float32),
        "alphas": np.zeros(m, dtype=np.float32),
        "offset_3D": np.zeros((m, 2), dtype=np.float32),
        "orientations": np.zeros((m, spec.orientation_bins * 2), dtype=np.float32),
        "reg_mask": np.zeros(m, dtype=np.float32),
        "trunc_mask": np.zeros(m, dtype=np.float32),
        "reg_weight": np.zeros(m, dtype=np.float32),
        "occlusions": np.zeros(m, dtype=np.float32),
        "truncations": np.zeros(m, dtype=np.float32),
        "pad_size": pad_size.astype(np.float32),
        "calib_params": calib.as_params(),
        "calib_P": calib.P.astype(np.float32),
        "img_size": np.array([img_w, img_h], dtype=np.float32),
    }

    if spec.enable_edge_fusion:
        edge = compute_edge_indices((img_w, img_h), pad_size, spec)
        edge_full = np.zeros((spec.max_edge_length, 2), dtype=np.int32)
        edge_full[: edge.shape[0]] = edge
        t["edge_indices"] = edge_full
        # the reference drops the final (duplicate corner) entry
        t["edge_len"] = np.array(edge.shape[0] - 1, dtype=np.int32)

    if objs is None:
        return t

    # feature-map bounds of the valid (un-padded) region
    x_min = int(np.ceil(pad_size[0] / spec.down_ratio))
    y_min = int(np.ceil(pad_size[1] / spec.down_ratio))
    x_max = int((pad_size[0] + img_w - 1) // spec.down_ratio)
    y_max = int((pad_size[1] + img_h - 1) // spec.down_ratio)

    for i, obj in enumerate(objs[:m]):
        cls_id = TYPE_ID_CONVERSION.get(obj.type, -99)
        if cls_id < 0:
            continue

        # 3D center = bottom center lifted by h/2; skip objects behind camera
        locs = obj.t.copy().astype(np.float64)
        locs[1] -= obj.h / 2
        if locs[2] <= 0:
            continue

        corners_3d = obj.generate_corners3d()
        corners_2d, _ = calib.project_rect_to_image(corners_3d)
        projected_box2d = np.array([
            corners_2d[:, 0].min(), corners_2d[:, 1].min(),
            corners_2d[:, 0].max(), corners_2d[:, 1].max(),
        ])
        if (projected_box2d[0] >= 0 and projected_box2d[1] >= 0
                and projected_box2d[2] <= img_w - 1 and projected_box2d[3] <= img_h - 1):
            box2d = projected_box2d.copy()
        else:
            box2d = obj.box2d.copy().astype(np.float64)

        if spec.filter_annos:
            if (obj.truncation >= spec.filter_params[0]
                    and (box2d[2:] - box2d[:2]).min() <= spec.filter_params[1]):
                continue

        proj_center, _ = calib.project_rect_to_image(locs.reshape(1, 3))
        proj_center = proj_center[0]

        inside = (0 <= proj_center[0] <= img_w - 1) and (0 <= proj_center[1] <= img_h - 1)
        approx_center = False
        if not inside:
            if not spec.consider_outside_objs:
                continue
            approx_center = True
            center_2d = (box2d[:2] + box2d[2:]) / 2
            if spec.proj_center_mode != "intersect":
                raise NotImplementedError(spec.proj_center_mode)
            res = approx_proj_center(proj_center, center_2d.reshape(1, 2), (img_w, img_h))
            if res is None:
                continue
            target_proj_center = res[0]
        else:
            target_proj_center = proj_center.copy()

        # 10 keypoints: 8 corners + bottom/top face centers
        bot_top_centers = np.stack(
            (corners_3d[:4].mean(axis=0), corners_3d[4:].mean(axis=0)), axis=0)
        keypoints_3d = np.concatenate((corners_3d, bot_top_centers), axis=0)
        keypoints_2d, _ = calib.project_rect_to_image(keypoints_3d)

        kx = (keypoints_2d[:, 0] >= 0) & (keypoints_2d[:, 0] <= img_w - 1)
        ky = (keypoints_2d[:, 1] >= 0) & (keypoints_2d[:, 1] <= img_h - 1)
        kz = keypoints_3d[:, 2] > 0
        visible = kx & ky & kz
        depth_valid = np.array([
            visible[[8, 9]].all(), visible[[0, 2, 4, 6]].all(), visible[[1, 3, 5, 7]].all()
        ])
        if spec.keypoint_visible_modify:
            # a corner counts as visible if its vertical partner is
            visible = np.append(np.tile(visible[:4] | visible[4:8], 2),
                                np.tile(visible[8] | visible[9], 2))
            depth_valid = np.array([
                visible[[8, 9]].all(), visible[[0, 2, 4, 6]].all(), visible[[1, 3, 5, 7]].all()
            ])
        visible = visible.astype(np.float32)
        depth_valid = depth_valid.astype(np.float32)

        # into the feature-map frame
        keypoints_2d = (keypoints_2d + pad_size.reshape(1, 2)) / spec.down_ratio
        target_proj_center = (target_proj_center + pad_size) / spec.down_ratio
        proj_center = (proj_center + pad_size) / spec.down_ratio
        box2d[0::2] += pad_size[0]
        box2d[1::2] += pad_size[1]
        box2d /= spec.down_ratio

        bbox_center = (box2d[:2] + box2d[2:]) / 2
        bbox_dim = box2d[2:] - box2d[:2]

        if spec.heatmap_center == "2D":
            target_center = np.round(bbox_center).astype(np.int64)
        else:
            target_center = np.round(target_proj_center).astype(np.int64)
        target_center[0] = np.clip(target_center[0], x_min, x_max)
        target_center[1] = np.clip(target_center[1], y_min, y_max)

        pred_2d = (box2d[0] <= target_center[0] <= box2d[2]
                   and box2d[1] <= target_center[1] <= box2d[3])

        if not ((bbox_dim > 0).all() and 0 <= target_center[0] <= out_w - 1
                and 0 <= target_center[1] <= out_h - 1):
            continue

        if spec.adjust_edge_heatmap and approx_center:
            # degenerate (1-D) gaussian along the border for truncated objects
            bw = min(target_center[0] - box2d[0], box2d[2] - target_center[0])
            bh = min(target_center[1] - box2d[1], box2d[3] - target_center[1])
            rx = max(0, int(bw * spec.edge_heatmap_ratio))
            ry_ = max(0, int(bh * spec.edge_heatmap_ratio))
            assert min(rx, ry_) == 0
            draw_ellip_gaussian(t["hm"][..., cls_id], target_center, rx, ry_)
        else:
            radius = gaussian_radius(bbox_dim[1], bbox_dim[0])
            draw_gaussian(t["hm"][..., cls_id], target_center, max(0, int(radius)))

        t["cls_ids"][i] = cls_id
        t["target_centers"][i] = target_center
        t["offset_3D"][i] = proj_center - target_center
        t["gt_bboxes"][i] = obj.box2d
        if pred_2d:
            t["2d_bboxes"][i] = box2d
        t["keypoints"][i] = np.concatenate(
            [keypoints_2d - target_center.reshape(1, 2), visible[:, None]], axis=1)
        t["keypoints_depth_mask"][i] = depth_valid
        t["dimensions"][i] = np.array([obj.l, obj.h, obj.w])
        t["locations"][i] = locs
        t["rotys"][i] = obj.ry
        t["alphas"][i] = obj.alpha
        t["orientations"][i] = encode_alpha_multibin(obj.alpha, num_bin=spec.orientation_bins)
        t["reg_mask"][i] = 1.0
        t["reg_weight"][i] = 1.0
        t["trunc_mask"][i] = float(approx_center)
        t["occlusions"][i] = float(obj.occlusion)
        t["truncations"][i] = obj.truncation

    return t
