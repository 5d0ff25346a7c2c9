"""The MonoFlex multi-task loss: 11 terms with learned uncertainties
(counterpart of ``monoflex_tpu/losses/loss_computation.py``).

Fixed-shape masked form: every object slot (B * MAX_OBJECTS rows) is computed
and the invalid ones are masked out of each mean.  The head maps are the
port's NCHW tensors; the batch targets keep the JAX package's layouts
(``hm`` is NHWC).  Gradients are stopped (``detach``) exactly where the JAX
loss stops them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from monoflex_tpu.models.heads.key2channel import Key2Channel

from ..core import geometry as G
from ..ops.image_ops import select_point_of_interest
from ..ops.rotated_iou import iou_3d_pairs
from .primitives import (berhu_loss, iou_loss_2d, l1, log_l1_loss, masked_mean,
                         multibin_orientation_loss, penalty_reduced_focal_loss, smooth_l1)

Tensors = Dict[str, torch.Tensor]


class LossComputer:
    def __init__(self, cfg):
        h = cfg.MODEL.HEAD
        self.k2c = Key2Channel(h.REGRESSION_HEADS, h.REGRESSION_CHANNELS)
        self.max_objs = cfg.DATASETS.MAX_OBJECTS
        self.down_ratio = cfg.MODEL.BACKBONE.DOWN_RATIO
        self.num_bin = cfg.INPUT.ORIENTATION_BIN_SIZE

        self.loss_weights = dict(zip(h.LOSS_NAMES, h.INIT_LOSS_WEIGHT))
        self.loss_keys = list(h.LOSS_NAMES)
        self.focal_alpha = h.LOSS_PENALTY_ALPHA
        self.focal_beta = h.LOSS_BETA
        self.iou_type = h.LOSS_TYPE[2]
        self.reg_loss_name = h.LOSS_TYPE[1]
        self.depth_loss_name = h.LOSS_TYPE[3]
        self.trunc_offset_loss_type = h.TRUNCATION_OFFSET_LOSS
        self.uncertainty_range = tuple(h.UNCERTAINTY_RANGE)
        self.corner_loss_depth = h.CORNER_LOSS_DEPTH
        self.modify_invalid_keypoint_depths = h.MODIFY_INVALID_KEYPOINT_DEPTH
        self.dim_weight = torch.tensor(h.DIMENSION_WEIGHT, dtype=torch.float32).reshape(1, 3)
        self.dim_mean = torch.tensor(h.DIMENSION_MEAN, dtype=torch.float32)
        self.dim_std = torch.tensor(h.DIMENSION_STD, dtype=torch.float32)
        self.dim_mode = h.DIMENSION_REG
        self.depth_mode = h.DEPTH_MODE
        self.depth_range = tuple(h.DEPTH_RANGE)
        self.depth_ref = tuple(h.DEPTH_REFERENCE)

        self.compute_direct_depth_loss = "depth_loss" in self.loss_keys
        self.compute_keypoint_depth_loss = "keypoint_depth_loss" in self.loss_keys
        self.compute_weighted_depth_loss = "weighted_avg_depth_loss" in self.loss_keys
        self.compute_corner_loss = "corner_loss" in self.loss_keys
        self.separate_trunc_offset = "trunc_offset_loss" in self.loss_keys
        self.pred_direct_depth = "depth" in self.k2c
        self.depth_with_uncertainty = "depth_uncertainty" in self.k2c
        self.compute_keypoint_corner = "corner_offset" in self.k2c
        self.corner_with_uncertainty = "corner_uncertainty" in self.k2c
        if self.corner_loss_depth not in ("direct", "keypoint_mean", "soft_combine",
                                          "hard_combine"):
            raise NotImplementedError(self.corner_loss_depth)
        if self.depth_loss_name not in ("L1", "berhu", "log"):
            raise NotImplementedError(self.depth_loss_name)

    def _reg_fn(self, pred, target):
        return l1(pred, target) if self.reg_loss_name == "L1" else smooth_l1(pred, target)

    def _depth_fn(self, pred_depth, target_depth):
        if self.depth_loss_name == "L1":
            return l1(pred_depth, target_depth)
        if self.depth_loss_name == "berhu":
            return berhu_loss(pred_depth, target_depth)
        return log_l1_loss(pred_depth, target_depth)

    def _clip_unc(self, u):
        return u.clamp(self.uncertainty_range[0], self.uncertainty_range[1])

    def __call__(self, predictions: Dict[str, object], batch: Tensors
                 ) -> Tuple[Tensors, Tensors]:
        """predictions: the detector's output, ``cls`` (B, classes, H, W) and
        ``reg`` a sequence of (B, c_i, H, W) maps in Key2Channel order.
        Returns (loss_dict, log_dict) with the JAX package's keys."""
        k2c = self.k2c
        w = self.loss_weights
        reg_maps = predictions["reg"]
        B = reg_maps[0].shape[0]
        C = sum(m.shape[1] for m in reg_maps)
        M = self.max_objs
        N = B * M
        dev = reg_maps[0].device
        dim_mean, dim_std = self.dim_mean.to(dev), self.dim_std.to(dev)

        def flat(x, *trailing):
            return x.reshape((N,) + trailing)

        mask3d = flat(batch["reg_mask"].float())
        batch_idx = torch.arange(B, device=dev).repeat_interleave(M)
        calib_params = batch["calib_params"][batch_idx]          # (N, 6)
        pad_size = batch["pad_size"][batch_idx]                  # (N, 2)

        points = flat(batch["target_centers"], 2).float()
        target_boxes = flat(batch["2d_bboxes"], 4)
        t_h = target_boxes[:, 3] - target_boxes[:, 1]
        t_w = target_boxes[:, 2] - target_boxes[:, 0]
        mask2d = mask3d * ((t_h > 0) & (t_w > 0)).float()
        target_reg_2d = torch.cat([points - target_boxes[:, :2], target_boxes[:, 2:] - points],
                                  dim=1)

        target_cls = flat(batch["cls_ids"])
        target_depth = flat(batch["locations"], 3)[:, 2]
        target_rotys = flat(batch["rotys"])
        target_offset = flat(batch["offset_3D"], 2)
        target_dims = flat(batch["dimensions"], 3)
        target_ori = flat(batch["orientations"], self.num_bin * 2)
        trunc_mask = flat(batch["trunc_mask"].float()) * mask3d

        # target locations are re-derived from (center + offset, depth), not
        # taken from the raw labels, as in the reference
        target_locs = G.decode_location(points, target_offset, target_depth, calib_params,
                                        pad_size, self.down_ratio)
        target_corners = G.encode_box3d(target_rotys, target_dims, target_locs)

        # ---- predictions at the GT centers ----
        poi = select_point_of_interest(reg_maps, batch["target_centers"]).reshape(N, C)
        pred_reg_2d = torch.relu(poi[:, k2c("2d_dim")])
        pred_offset = poi[:, k2c("3d_offset")]
        pred_ori = torch.cat([poi[:, k2c("ori_cls")], poi[:, k2c("ori_offset")]], dim=1)
        pred_dims = G.decode_dimension(target_cls, poi[:, k2c("3d_dim")], dim_mean, dim_std,
                                       mode=self.dim_mode[0], use_std=bool(self.dim_mode[2]))

        loss_dict: Tensors = {}
        log_dict: Tensors = {}

        # ---- heatmap focal loss (the head map is NCHW, the target NHWC) ----
        hm_loss, num_pos = penalty_reduced_focal_loss(
            predictions["cls"].permute(0, 2, 3, 1), batch["hm"], self.focal_alpha,
            self.focal_beta)
        loss_dict["hm_loss"] = w["hm_loss"] * hm_loss / num_pos.clamp(min=1.0)

        # ---- 2D GIoU ----
        reg2d_losses, ious_2d = iou_loss_2d(pred_reg_2d, target_reg_2d, self.iou_type)
        loss_dict["bbox_loss"] = w["bbox_loss"] * masked_mean(reg2d_losses, mask2d)
        log_dict["2D_IoU"] = masked_mean(ious_2d, mask2d)

        # ---- direct depth (+ uncertainty) ----
        pred_direct_depth = pred_depth_unc = None
        if self.pred_direct_depth:
            pred_direct_depth = G.decode_depth(poi[:, k2c("depth")][:, 0], self.depth_mode,
                                               self.depth_ref, self.depth_range)
        if self.depth_with_uncertainty:
            pred_depth_unc = self._clip_unc(poi[:, k2c("depth_uncertainty")][:, 0])
        if self.compute_direct_depth_loss and pred_direct_depth is not None:
            depth_l = w["depth_loss"] * self._depth_fn(pred_direct_depth, target_depth)
            log_dict["depth_loss"] = masked_mean(depth_l.detach(), mask3d)
            if pred_depth_unc is not None:
                depth_l = depth_l * torch.exp(-pred_depth_unc) + pred_depth_unc * w["depth_loss"]
            loss_dict["depth_loss"] = masked_mean(depth_l, mask3d)
            log_dict["depth_MAE"] = masked_mean(
                (pred_direct_depth - target_depth).abs() / target_depth.clamp(min=1e-6), mask3d)

        # ---- offset (truncated objects split off with a log penalty) ----
        offset_l = self._reg_fn(pred_offset, target_offset).sum(dim=1)
        if self.separate_trunc_offset:
            trunc_l = torch.log1p(offset_l) if self.trunc_offset_loss_type == "log" else offset_l
            loss_dict["trunc_offset_loss"] = (w["trunc_offset_loss"] * (trunc_l * trunc_mask).sum()
                                              / trunc_mask.sum().clamp(min=1.0))
            loss_dict["offset_loss"] = w["offset_loss"] * masked_mean(
                offset_l, mask3d * (1.0 - trunc_mask))
        else:
            loss_dict["offset_loss"] = w["offset_loss"] * masked_mean(offset_l, mask3d)

        # ---- orientation ----
        loss_dict["orien_loss"] = w["orien_loss"] * multibin_orientation_loss(
            pred_ori, target_ori, mask3d, self.num_bin)

        # ---- dimensions ----
        dims_l = (self._reg_fn(pred_dims, target_dims) * self.dim_weight.to(dev)).sum(dim=1)
        loss_dict["dims_loss"] = w["dims_loss"] * masked_mean(dims_l, mask3d)

        # ---- keypoints + keypoint depths ----
        pred_kpt_depths = pred_corner_unc = None
        if self.compute_keypoint_corner:
            target_kpts = flat(batch["keypoints"], 10, 3)
            kpt_mask = target_kpts[..., 2] * mask3d[:, None]
            pred_kpts = poi[:, k2c("corner_offset")].reshape(N, 10, 2)
            kpt_l = l1(pred_kpts, target_kpts[..., :2]).sum(dim=2) * kpt_mask
            loss_dict["keypoint_loss"] = (w["keypoint_loss"] * kpt_l.sum()
                                          / kpt_mask.sum().clamp(min=1.0))
            pred_kpt_depths = G.decode_depth_from_keypoints(
                pred_kpts, pred_dims, calib_params, self.down_ratio, self.depth_range)
            if self.corner_with_uncertainty:
                pred_corner_unc = self._clip_unc(poi[:, k2c("corner_uncertainty")])

            if self.compute_keypoint_depth_loss:
                kd_valid = flat(batch["keypoints_depth_mask"], 3) * mask3d[:, None]
                kd_invalid = (1.0 - flat(batch["keypoints_depth_mask"], 3)) * mask3d[:, None]
                target_kd = target_depth[:, None].expand(N, 3)
                wk = w["keypoint_depth_loss"]
                valid_l = wk * self._reg_fn(pred_kpt_depths, target_kd)
                invalid_l = wk * self._reg_fn(pred_kpt_depths.detach(), target_kd)
                log_dict["keypoint_depth_loss"] = ((valid_l.detach() * kd_valid).sum()
                                                   / kd_valid.sum().clamp(min=1.0))
                if pred_corner_unc is not None:
                    valid_l = valid_l * torch.exp(-pred_corner_unc) + wk * pred_corner_unc
                    invalid_l = invalid_l * torch.exp(-pred_corner_unc)
                valid_term = (valid_l * kd_valid).sum() / kd_valid.sum().clamp(min=1.0)
                invalid_term = (invalid_l * kd_invalid).sum() / kd_invalid.sum().clamp(min=1.0)
                loss_dict["keypoint_depth_loss"] = (
                    valid_term + invalid_term if self.modify_invalid_keypoint_depths
                    else valid_term)

            kpt_mae = ((pred_kpt_depths - target_depth[:, None]).abs()
                       / target_depth[:, None].clamp(min=1e-6))
            log_dict["center_MAE"] = masked_mean(kpt_mae[:, 0], mask3d)
            log_dict["02_MAE"] = masked_mean(kpt_mae[:, 1], mask3d)
            log_dict["13_MAE"] = masked_mean(kpt_mae[:, 2], mask3d)

        # ---- depth ensembles for the corner loss + diagnostics ----
        soft_depths = None
        if (self.corner_with_uncertainty and self.pred_direct_depth
                and self.depth_with_uncertainty and pred_kpt_depths is not None):
            combined_depth = torch.cat([pred_direct_depth[:, None], pred_kpt_depths], dim=1)
            combined_unc = torch.exp(torch.cat([pred_depth_unc[:, None], pred_corner_unc],
                                               dim=1))
            combined_mae = ((combined_depth - target_depth[:, None]).abs()
                            / target_depth[:, None].clamp(min=1e-6))
            log_dict["lower_MAE"] = masked_mean(combined_mae.min(dim=1).values, mask3d)
            hard_idx = combined_unc.argmin(dim=1, keepdim=True)
            log_dict["hard_MAE"] = masked_mean(combined_mae.gather(1, hard_idx)[:, 0], mask3d)
            weights = 1.0 / combined_unc
            weights = weights / weights.sum(dim=1, keepdim=True)
            soft_depths = (combined_depth * weights).sum(dim=1)
            log_dict["soft_MAE"] = masked_mean(
                (soft_depths - target_depth).abs() / target_depth.clamp(min=1e-6), mask3d)
            log_dict["mean_MAE"] = masked_mean(
                (combined_depth.mean(dim=1) - target_depth).abs()
                / target_depth.clamp(min=1e-6), mask3d)

        if self.corner_loss_depth == "direct":
            corner_depth = pred_direct_depth
        elif self.corner_loss_depth == "keypoint_mean":
            corner_depth = pred_kpt_depths.mean(dim=1)
        elif self.corner_loss_depth == "soft_combine":
            corner_depth = soft_depths
        else:   # hard_combine
            combined_depth = torch.cat([pred_direct_depth[:, None], pred_kpt_depths], dim=1)
            combined_unc = torch.exp(torch.cat([pred_depth_unc[:, None], pred_corner_unc],
                                               dim=1))
            corner_depth = combined_depth.gather(1, combined_unc.argmin(dim=1, keepdim=True))[:, 0]

        # ---- 3D box assembly + corner loss ----
        pred_locs = G.decode_location(points, pred_offset, corner_depth, calib_params, pad_size,
                                      self.down_ratio)
        pred_rotys, _ = G.decode_axes_orientation(pred_ori, pred_locs, self.num_bin)
        pred_corners = G.encode_box3d(pred_rotys, pred_dims, pred_locs)

        log_dict["3D_IoU"] = masked_mean(iou_3d_pairs(pred_corners, target_corners), mask3d)

        if self.compute_corner_loss:
            corner_l = self._reg_fn(pred_corners, target_corners).sum(dim=2)   # (N, 8)
            loss_dict["corner_loss"] = w["corner_loss"] * masked_mean(
                corner_l, mask3d[:, None].expand(N, 8))

        if self.compute_weighted_depth_loss and soft_depths is not None:
            loss_dict["weighted_avg_depth_loss"] = (
                w["weighted_avg_depth_loss"]
                * masked_mean(self._reg_fn(soft_depths, target_depth), mask3d))

        for key, value in loss_dict.items():
            if key not in log_dict:
                log_dict[key] = value.detach()
        return loss_dict, log_dict
