"""Greedy box NMS over the fixed K decoded detections (counterpart of
``monoflex_tpu/decode/nms.py``).

Covers the reference's TEST.USE_NMS post-filter ('2d' axis-aligned or '3d'
BEV).  Fixed shapes: it returns an updated validity mask rather than
compacting.  Batched: one loop over the K ranks serves every image at once.
"""

from __future__ import annotations

from typing import Optional

import torch


def _iou_2d_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) xyxy -> (..., K, K) IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :])).clamp(min=0)
    iy = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :])).clamp(min=0)
    inter = ix * iy
    return inter / (area[..., :, None] + area[..., None, :] - inter).clamp(min=1e-6)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               classes: Optional[torch.Tensor] = None, iou_thresh: float = 0.5
               ) -> torch.Tensor:
    """Greedy NMS per image: boxes (B, K, 4), scores, valid and classes (B, K);
    returns the surviving-validity mask (B, K).  ``classes`` None ->
    class-agnostic (TEST.NMS_CLASS_AGNOSTIC).

    Boxes are visited by descending score (valid first, ties in index order,
    as the JAX package's stable argsort); a box is dropped if a kept box of
    higher rank overlaps it by more than ``iou_thresh``."""
    B, K = scores.shape
    iou = _iou_2d_matrix(boxes)
    if classes is not None:
        iou = torch.where(classes[:, :, None] == classes[:, None, :], iou, torch.zeros_like(iou))
    neg_inf = torch.full_like(scores, float("-inf"))
    order = torch.argsort(-torch.where(valid, scores, neg_inf), dim=1, stable=True)
    rows = torch.arange(B, device=scores.device)[:, None]
    # IoU and validity in rank order
    overlaps = iou[rows[:, :, None], order[:, :, None], order[:, None, :]] > iou_thresh
    keep = valid.bool().gather(1, order)
    for i in range(1, K):
        suppressed = (overlaps[:, i, :i] & keep[:, :i]).any(dim=1)
        keep[:, i] &= ~suppressed
    out = torch.empty_like(keep)
    out[rows, order] = keep
    return out


def apply_nms(result: torch.Tensor, valid: torch.Tensor, mode: str = "2d",
              iou_thresh: float = 0.5, class_agnostic: bool = False) -> torch.Tensor:
    """result (B, K, 14) decode rows; returns the updated valid (B, K)."""
    if mode == "3d":
        # BEV axis-aligned approximation over (x, z) extents
        x, z = result[..., 9], result[..., 11]
        w, l = result[..., 7], result[..., 8]
        boxes = torch.stack([x - l / 2, z - w / 2, x + l / 2, z + w / 2], dim=-1)
    else:
        boxes = result[..., 2:6]
    classes = None if class_agnostic else result[..., 0]
    return greedy_nms(boxes, result[..., 13], valid, classes, iou_thresh)
