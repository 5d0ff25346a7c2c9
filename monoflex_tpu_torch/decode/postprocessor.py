"""Detection decoding on the device (counterpart of
``monoflex_tpu/decode/postprocessor.py``): max-pool NMS -> two-stage top-k ->
per-peak decode of 2D box, dimensions, orientation and the depth ensemble ->
back-projection to 3D -> uncertainty-guided confidence -> box NMS when
TEST.USE_NMS asks for it (``decode/nms.py``).

Fixed shapes: every image yields exactly K rows plus a validity mask
(score >= threshold).  Head maps come in NCHW.  Top-k is exact: ApproxTopK
is a TPU-only option of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core import geometry as G
from ..models.heads.key2channel import Key2Channel
from ..ops.image_ops import nms_hm, select_point_of_interest, select_topk
from .nms import apply_nms

# output row layout: [cls, alpha, x1, y1, x2, y2, h, w, l, x, y, z, roty, score]
RESULT_DIM = 14

_KEYPOINT_COLUMN = {"keypoints_avg": None, "keypoints_center": 0,
                    "keypoints_02": 1, "keypoints_13": 2}


def _pick(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[n, idx[n]] for (N, M) t and (N,) idx."""
    return t.gather(1, idx[:, None])[:, 0]


class PostProcessor:
    def __init__(self, cfg):
        h = cfg.MODEL.HEAD
        self.k2c = Key2Channel(h.REGRESSION_HEADS, h.REGRESSION_CHANNELS)
        self.det_threshold = cfg.TEST.DETECTIONS_THRESHOLD
        self.max_detection = cfg.TEST.DETECTIONS_PER_IMG
        self.output_depth = h.OUTPUT_DEPTH
        self.uncertainty_as_conf = cfg.TEST.UNCERTAINTY_AS_CONFIDENCE
        self.use_nms = cfg.TEST.USE_NMS
        self.nms_thresh = cfg.TEST.NMS_THRESH
        self.nms_class_agnostic = cfg.TEST.NMS_CLASS_AGNOSTIC
        self.down_ratio = cfg.MODEL.BACKBONE.DOWN_RATIO
        self.num_bin = cfg.INPUT.ORIENTATION_BIN_SIZE
        self.depth_mode = h.DEPTH_MODE
        self.depth_range = tuple(h.DEPTH_RANGE)
        self.depth_ref = tuple(h.DEPTH_REFERENCE)
        self.dim_mean = torch.tensor(h.DIMENSION_MEAN, dtype=torch.float32)
        self.dim_std = torch.tensor(h.DIMENSION_STD, dtype=torch.float32)
        self.dim_mode = h.DIMENSION_REG

        self.pred_direct_depth = "depth" in self.k2c
        self.depth_with_uncertainty = "depth_uncertainty" in self.k2c
        self.regress_keypoints = "corner_offset" in self.k2c
        self.keypoint_depth_with_uncertainty = "corner_uncertainty" in self.k2c

    def __call__(self, predictions: Dict[str, object], batch: Dict[str, torch.Tensor],
                 output_depth: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (results (B, K, 14), valid (B, K) bool, extras dict)."""
        k2c = self.k2c
        K = self.max_detection
        scores, flat_inds, clses, ys, xs = select_topk(nms_hm(predictions["cls"]), K)
        B = scores.shape[0]
        N = B * K
        dev = scores.device

        poi = select_point_of_interest(predictions["reg"], flat_inds).reshape(N, -1)
        scores = scores.reshape(N)
        clses = clses.reshape(N)
        points = torch.stack([xs.reshape(N), ys.reshape(N)], dim=1)
        valid = scores >= self.det_threshold

        batch_idx = torch.arange(B, device=dev).repeat_interleave(K)
        calib_params = batch["calib_params"][batch_idx]
        pad_size = batch["pad_size"][batch_idx]
        img_size = batch["img_size"][batch_idx]

        pred_offset = poi[:, k2c("3d_offset")]
        pred_ori = torch.cat([poi[:, k2c("ori_cls")], poi[:, k2c("ori_offset")]], dim=1)
        box2d = G.decode_box2d_fcos(points, torch.relu(poi[:, k2c("2d_dim")]), pad_size,
                                    img_size, self.down_ratio)
        # non-blocking: a pageable upload that blocks waits for the forward
        dims = G.decode_dimension(clses, poi[:, k2c("3d_dim")],
                                  self.dim_mean.to(dev, non_blocking=True),
                                  self.dim_std.to(dev, non_blocking=True), mode=self.dim_mode[0],
                                  use_std=bool(self.dim_mode[2]))

        extras: Dict[str, torch.Tensor] = {}
        direct_depth = direct_unc = kpt_depths = kpt_unc = None
        if self.pred_direct_depth:
            direct_depth = G.decode_depth(poi[:, k2c("depth")][:, 0], self.depth_mode,
                                          self.depth_ref, self.depth_range)
        if self.depth_with_uncertainty:
            direct_unc = torch.exp(poi[:, k2c("depth_uncertainty")][:, 0])
        if self.regress_keypoints:
            kpts = poi[:, k2c("corner_offset")].reshape(N, 10, 2)
            kpt_depths = G.decode_depth_from_keypoints(kpts, dims, calib_params,
                                                       self.down_ratio, self.depth_range)
            extras["keypoints"] = kpts.reshape(B, K, 10, 2)
        if self.keypoint_depth_with_uncertainty:
            kpt_unc = torch.exp(poi[:, k2c("corner_uncertainty")])

        depth_sel = output_depth or self.output_depth
        est_err = None
        if depth_sel == "direct":
            depths, est_err = direct_depth, direct_unc
        elif depth_sel in _KEYPOINT_COLUMN:
            col = _KEYPOINT_COLUMN[depth_sel]
            if col is None:
                depths = kpt_depths.mean(dim=1)
                est_err = kpt_unc.mean(dim=1) if kpt_unc is not None else None
            else:
                depths = kpt_depths[:, col]
                est_err = kpt_unc[:, col] if kpt_unc is not None else None
        elif depth_sel == "oracle":
            depths, est_err = self._oracle_depth(batch, batch_idx, box2d, clses,
                                                 direct_depth, direct_unc, kpt_depths, kpt_unc)
        elif depth_sel in ("hard", "soft", "mean"):
            if self.pred_direct_depth and self.depth_with_uncertainty:
                comb_d = torch.cat([direct_depth[:, None], kpt_depths], dim=1)
                comb_u = torch.cat([direct_unc[:, None], kpt_unc], dim=1)
            else:
                comb_d, comb_u = kpt_depths, kpt_unc
            inv = 1.0 / comb_u
            if depth_sel == "hard":
                depths = _pick(comb_d, inv.argmax(dim=1))
                est_err = comb_u.min(dim=1).values
            elif depth_sel == "soft":
                wgt = inv / inv.sum(dim=1, keepdim=True)
                depths = (comb_d * wgt).sum(dim=1)
                est_err = (wgt * comb_u).sum(dim=1)
            else:
                depths = comb_d.mean(dim=1)
                est_err = comb_u.mean(dim=1)
            extras["min_uncertainty"] = inv.argmax(dim=1)
        else:
            raise NotImplementedError(depth_sel)

        locations = G.decode_location(points, pred_offset, depths, calib_params,
                                      pad_size, self.down_ratio)
        rotys, alphas = G.decode_axes_orientation(pred_ori, locations, self.num_bin)
        # 3D-center y -> KITTI bottom-center y; (l, h, w) -> (h, w, l)
        locations = torch.cat([locations[:, :1], locations[:, 1:2] + dims[:, 1:2] / 2.0,
                               locations[:, 2:]], dim=1)
        dims_hwl = torch.roll(dims, shifts=-1, dims=1)

        vis_scores = scores
        if self.uncertainty_as_conf and est_err is not None:
            conf = 1.0 - est_err.clamp(0.01, 1.0)
            scores = scores * conf
            extras["uncertainty_conf"] = conf.reshape(B, K)
            extras["estimated_depth_error"] = est_err.reshape(B, K)

        result = torch.cat([clses[:, None], alphas[:, None], box2d, dims_hwl, locations,
                            rotys[:, None], scores[:, None]], dim=1).reshape(B, K, RESULT_DIM)
        extras["vis_scores"] = vis_scores.reshape(B, K)
        extras["points"] = points.reshape(B, K, 2)
        extras["heatmap"] = predictions["cls"]
        valid = valid.reshape(B, K)
        if self.use_nms in ("2d", "3d") and self.nms_thresh > 0:
            valid = apply_nms(result, valid, mode=self.use_nms, iou_thresh=self.nms_thresh,
                              class_agnostic=self.nms_class_agnostic)
        return result, valid, extras

    @staticmethod
    def _oracle_depth(batch, batch_idx, box2d, clses, direct_depth, direct_unc,
                      kpt_depths, kpt_unc):
        """Match each prediction to the nearest same-class GT 2D box; at IoU
        > 0.5 take the estimator closest to the GT depth, else the mean."""
        comb_d = torch.cat([direct_depth[:, None], kpt_depths], dim=1)
        comb_u = torch.cat([direct_unc[:, None], kpt_unc], dim=1)
        gt_boxes = batch["gt_bboxes"][batch_idx]                       # (N, M, 4)
        gt_cls = batch["cls_ids"][batch_idx]
        gt_depth = batch["locations"][batch_idx][..., 2]
        gt_valid = batch["reg_mask"][batch_idx] > 0

        gt_centers = (gt_boxes[..., :2] + gt_boxes[..., 2:]) / 2
        pred_center = (box2d[:, :2] + box2d[:, 2:]) / 2
        dist = ((pred_center[:, None, :] - gt_centers) ** 2).sum(dim=2)
        same_cls = (gt_cls == clses[:, None].to(gt_cls.dtype)) & gt_valid
        dist = torch.where(same_cls, dist, torch.full_like(dist, 9999.0))
        near = dist.argmin(dim=1)
        near_box = gt_boxes[torch.arange(len(near), device=near.device), near]
        ix = (torch.minimum(box2d[:, 2], near_box[:, 2])
              - torch.maximum(box2d[:, 0], near_box[:, 0])).clamp(min=0)
        iy = (torch.minimum(box2d[:, 3], near_box[:, 3])
              - torch.maximum(box2d[:, 1], near_box[:, 1])).clamp(min=0)
        inter = ix * iy
        area_p = ((box2d[:, 2] - box2d[:, 0]) * (box2d[:, 3] - box2d[:, 1])).clamp(min=0)
        area_g = ((near_box[:, 2] - near_box[:, 0])
                  * (near_box[:, 3] - near_box[:, 1])).clamp(min=0)
        matched = inter / (area_p + area_g - inter).clamp(min=1e-6) > 0.5
        best = (comb_d - _pick(gt_depth, near)[:, None]).abs().argmin(dim=1)
        depths = torch.where(matched, _pick(comb_d, best), comb_d.mean(dim=1))
        est_err = torch.where(matched, _pick(comb_u, best), comb_u.mean(dim=1))
        return depths, est_err


def build_postprocessor(cfg):
    """The decode of ``MODEL.META_ARCHITECTURE``'s head maps: ``PostProcessor``
    for MonoFlex, ``decode/fcos3d.py::FCOS3DDecoder`` for FCOSMono3D,
    ``decode/bevformer.py::BEVFormerDecoder`` for BEVFormer."""
    if cfg.MODEL.META_ARCHITECTURE == "FCOSMono3D":
        from .fcos3d import FCOS3DDecoder

        return FCOS3DDecoder()
    if cfg.MODEL.META_ARCHITECTURE == "BEVFormer":
        from .bevformer import BEVFormerDecoder

        return BEVFormerDecoder()
    return PostProcessor(cfg)
