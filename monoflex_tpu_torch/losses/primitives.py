"""Loss primitives, mask-weighted and fixed-shape (counterpart of
``monoflex_tpu/losses/primitives.py``): every function takes explicit
element masks instead of compacting the valid rows."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(x * mask) / clamp(sum(mask), 1): the mean over the valid rows."""
    return (x * mask).sum() / mask.sum().clamp(min=1.0)


def penalty_reduced_focal_loss(prediction: torch.Tensor, target: torch.Tensor,
                               alpha: float = 2.0, beta: float = 4.0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CenterNet penalty-reduced focal loss on an already-sigmoided heatmap:
    target 1 is a positive, -1 an ignored pixel, anything else a negative
    weighted by (1 - target)^beta.  Returns (summed loss, number of
    positives); the caller divides."""
    positive = (target == 1.0).to(prediction.dtype)
    negative = ((target < 1.0) & (target >= 0.0)).to(prediction.dtype)
    negative_weights = torch.pow(1.0 - target.clamp(0.0, 1.0), beta)
    positive_loss = torch.log(prediction) * torch.pow(1.0 - prediction, alpha) * positive
    negative_loss = (torch.log(1.0 - prediction) * torch.pow(prediction, alpha)
                     * negative_weights * negative)
    return -(positive_loss.sum() + negative_loss.sum()), positive.sum()


def iou_loss_2d(pred: torch.Tensor, target: torch.Tensor, loss_type: str = "giou"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FCOS-style (l, t, r, b) distance IoU losses per row: (loss (N,), iou (N,))."""
    pl, pt, pr, pb = pred.unbind(1)
    tl, tt, tr, tb = target.unbind(1)
    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_intersect = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    g_w_intersect = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    h_intersect = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_h_intersect = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    ac_union = g_w_intersect * g_h_intersect + 1e-7
    area_intersect = w_intersect * h_intersect
    area_union = target_area + pred_area - area_intersect
    ious = (area_intersect + 1.0) / (area_union + 1.0)
    gious = ious - (ac_union - area_union) / ac_union
    if loss_type == "iou":
        losses = -torch.log(ious.clamp(min=1e-7))
    elif loss_type == "linear_iou":
        losses = 1.0 - ious
    elif loss_type == "giou":
        losses = 1.0 - gious
    else:
        raise NotImplementedError(loss_type)
    return losses, ious


def berhu_loss(pred: torch.Tensor, target: torch.Tensor, c_factor: float = 0.2) -> torch.Tensor:
    """Reverse Huber: L1 below the adaptive threshold c, scaled L2 above."""
    diff = (pred - target).abs()
    c = (diff.max() * c_factor).clamp(min=1e-4)
    return torch.where(diff <= c, diff, (diff ** 2 + c ** 2) / (2.0 * c))


def inverse_sigmoid_loss(pred_offset: torch.Tensor, target_depth: torch.Tensor) -> torch.Tensor:
    """L1 in the inverse-sigmoid-encoded depth space."""
    return (pred_offset - torch.log(1.0 / target_depth.clamp(min=1e-6) + 1e-12)).abs()


def log_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (torch.log(pred.clamp(min=1e-6)) - torch.log(target.clamp(min=1e-6))).abs()


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs()


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def multibin_orientation_loss(vector_ori: torch.Tensor, gt_ori: torch.Tensor,
                              mask: torch.Tensor, num_bin: int = 4) -> torch.Tensor:
    """Multibin loss: per bin a 2-way cross entropy (mean over the valid
    objects, summed over bins / num_bin) plus L1 on the normalized (sin, cos)
    of the active bins.  vector_ori (N, 4*num_bin); gt_ori (N, 2*num_bin) =
    [cls x num_bin, offset x num_bin]; mask (N,)."""
    n = vector_ori.shape[0]
    logits = vector_ori[:, :num_bin * 2].reshape(n, num_bin, 2)
    gt_cls = gt_ori[:, :num_bin]
    gt_off = gt_ori[:, num_bin:]

    log_probs = F.log_softmax(logits, dim=2)
    ce = -log_probs.gather(2, gt_cls.long()[..., None])[..., 0]
    per_bin_mean = (ce * mask[:, None]).sum(dim=0) / mask.sum().clamp(min=1.0)
    cls_loss = per_bin_mean.sum()

    sincos = vector_ori[:, num_bin * 2:].reshape(n, num_bin, 2)
    sincos = sincos / torch.linalg.vector_norm(sincos, dim=2, keepdim=True).clamp(min=1e-9)
    active = (gt_cls == 1.0).to(vector_ori.dtype) * mask[:, None]
    reg = ((sincos[..., 0] - torch.sin(gt_off)).abs()
           + (sincos[..., 1] - torch.cos(gt_off)).abs())
    reg_loss = (reg * active).sum() / active.sum().clamp(min=1.0)
    return cls_loss / num_bin + reg_loss
