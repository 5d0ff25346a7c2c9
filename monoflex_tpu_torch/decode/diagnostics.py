"""On-device diagnostic evaluators: the depth-error suite and the disentangled
3D IoU (counterpart of ``monoflex_tpu/decode/diagnostics.py``).

Ports of the reference's in-model diagnostics (reference:
model/head/detector_infer.py:280-452): per-estimator depth errors with the
oracle lower bound, and 3D IoU disentangled per component (offset / depth /
dimension / orientation each swapped into the ground-truth box).  Masked
fixed-shape means over the encoded targets; enabled by TEST.EVAL_DEPTH /
TEST.EVAL_DIS_IOUS.  Regression maps come in NCHW, as the model gives them.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core import geometry as G
from ..losses.primitives import masked_mean
from ..models.heads.key2channel import Key2Channel
from ..ops.image_ops import select_point_of_interest
from ..ops.rotated_iou import iou_3d_pairs


class DiagnosticEvaluator:
    def __init__(self, cfg):
        h = cfg.MODEL.HEAD
        self.k2c = Key2Channel(h.REGRESSION_HEADS, h.REGRESSION_CHANNELS)
        self.down_ratio = cfg.MODEL.BACKBONE.DOWN_RATIO
        self.num_bin = cfg.INPUT.ORIENTATION_BIN_SIZE
        self.depth_mode = h.DEPTH_MODE
        self.depth_range = tuple(h.DEPTH_RANGE)
        self.depth_ref = tuple(h.DEPTH_REFERENCE)
        self.dim_mean = torch.tensor(h.DIMENSION_MEAN, dtype=torch.float32)
        self.dim_std = torch.tensor(h.DIMENSION_STD, dtype=torch.float32)
        self.dim_mode = h.DIMENSION_REG

    def _poi(self, batch, reg_map):
        M = batch["reg_mask"].shape[1]
        poi = select_point_of_interest(reg_map, batch["target_centers"])
        B, _, C = poi.shape
        N = B * M
        mask = batch["reg_mask"].reshape(N).float()
        batch_idx = torch.arange(B, device=poi.device).repeat_interleave(M)
        return poi.reshape(N, C), mask, batch_idx, N

    def _decode_common(self, batch, poi, batch_idx, N):
        k2c = self.k2c
        dev = poi.device
        calib = batch["calib_params"][batch_idx]
        cls_ids = batch["cls_ids"].reshape(N)
        dims = G.decode_dimension(cls_ids, poi[:, k2c("3d_dim")], self.dim_mean.to(dev),
                                  self.dim_std.to(dev), mode=self.dim_mode[0],
                                  use_std=bool(self.dim_mode[2]))
        direct_depth = G.decode_depth(poi[:, k2c("depth")][:, 0], self.depth_mode,
                                      self.depth_ref, self.depth_range)
        kpts = poi[:, k2c("corner_offset")].reshape(N, 10, 2)
        kpt_depths = G.decode_depth_from_keypoints(kpts, dims, calib, self.down_ratio,
                                                   self.depth_range)
        direct_unc = torch.exp(poi[:, k2c("depth_uncertainty")])
        kpt_unc = torch.exp(poi[:, k2c("corner_uncertainty")])
        comb_depths = torch.cat([direct_depth[:, None], kpt_depths], dim=1)
        comb_unc = torch.cat([direct_unc, kpt_unc], dim=1)
        return dims, direct_depth, comb_depths, comb_unc, calib

    def evaluate_depths(self, batch, reg_map) -> Dict[str, torch.Tensor]:
        """Masked means of per-estimator absolute depth errors
        (reference: detector_infer.py:280-359)."""
        poi, mask, batch_idx, N = self._poi(batch, reg_map)
        _, _, comb_depths, comb_unc, _ = self._decode_common(batch, poi, batch_idx, N)

        target_depths = batch["locations"].reshape(N, 3)[:, 2]
        err = (comb_depths - target_depths[:, None]).abs()
        hard_err = err.gather(1, comb_unc.argmin(dim=1, keepdim=True))[:, 0]
        weights = 1.0 / comb_unc
        weights = weights / weights.sum(dim=1, keepdim=True)
        soft_depth = (comb_depths * weights).sum(dim=1)

        out = {
            "direct": err[:, 0],
            "keypoint_center": err[:, 1],
            "keypoint_02": err[:, 2],
            "keypoint_13": err[:, 3],
            "sigma_min": hard_err,
            "sigma_weighted": (soft_depth - target_depths).abs(),
            "mean": (comb_depths.mean(dim=1) - target_depths).abs(),
            "min": err.min(dim=1).values,
            "direct_sigma": comb_unc[:, 0],
            "keypoint_center_sigma": comb_unc[:, 1],
            "keypoint_02_sigma": comb_unc[:, 2],
            "keypoint_13_sigma": comb_unc[:, 3],
        }
        return {k: masked_mean(v, mask) for k, v in out.items()}

    def evaluate_disentangled_iou(self, batch, reg_map,
                                  output_depth: str = "soft") -> Dict[str, torch.Tensor]:
        """3D IoU with one predicted component swapped into the GT box
        (reference: detector_infer.py:361-452)."""
        k2c = self.k2c
        poi, mask, batch_idx, N = self._poi(batch, reg_map)
        dims, direct_depth, comb_depths, comb_unc, calib = self._decode_common(
            batch, poi, batch_idx, N)
        pad = batch["pad_size"][batch_idx]
        points = batch["target_centers"].reshape(N, 2).float()

        t_locs = batch["locations"].reshape(N, 3)
        t_dims = batch["dimensions"].reshape(N, 3)
        t_rotys = batch["rotys"].reshape(N)
        t_offset = batch["offset_3D"].reshape(N, 2)
        t_depths = t_locs[:, 2]

        pred_offset = poi[:, k2c("3d_offset")]
        pred_ori = torch.cat([poi[:, k2c("ori_cls")], poi[:, k2c("ori_offset")]], dim=1)
        if output_depth == "direct":
            pred_depths = direct_depth
        else:
            pred_depths = comb_depths.gather(1, comb_unc.argmin(dim=1, keepdim=True))[:, 0]

        def dec(off, dep):
            return G.decode_location(points, off, dep, calib, pad, self.down_ratio)

        loc_offset = dec(pred_offset, t_depths)      # only the offset predicted
        loc_depth = dec(t_offset, pred_depths)       # only the depth predicted
        loc_full = dec(pred_offset, pred_depths)

        rotys_at_gt, _ = G.decode_axes_orientation(pred_ori, t_locs, self.num_bin)
        rotys_full, _ = G.decode_axes_orientation(pred_ori, loc_full, self.num_bin)
        tgt_c = G.encode_box3d(t_rotys, t_dims, t_locs)

        def iou(locs, dims_, rotys_):
            pred_c = G.encode_box3d(rotys_, dims_, locs)
            return masked_mean(iou_3d_pairs(pred_c, tgt_c), mask)

        return {
            "pred_IoU": iou(loc_full, dims, rotys_full),
            "offset_IoU": iou(loc_offset, t_dims, t_rotys),
            "depth_IoU": iou(loc_depth, t_dims, t_rotys),
            "dims_IoU": iou(t_locs, dims, t_rotys),
            "orien_IoU": iou(t_locs, t_dims, rotys_at_gt),
        }
