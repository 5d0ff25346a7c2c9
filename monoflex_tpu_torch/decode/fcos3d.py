"""FCOS3D's decode on the device (mmdetection3d's
``FCOSMono3DHead._get_bboxes_single``, ``FCOS3DBBoxCoder`` and
``box3d_multiclass_nms`` with ``use_rotate_nms``), for the head maps of
``models/heads/fcos3d.py``.

1. Span ``decode.topk``: per image and level, the ``NMS_PRE`` locations
   with the highest class score x centerness (all of a smaller level); each
   location's head values (the candidates), its point (x, y) * stride +
   stride // 2 and its stride.
2. The candidates' boxes (still ``decode.topk``): the 2D centre is the
   point less the offset times the stride, depth and size are
   exponentials, the centre is unprojected with the image's camera
   (``batch["cam_intrinsic"]``, (B, 3, 3), no skew), the yaw comes from
   the rotation and the direction classifier (``DIR_OFFSET``) and turns by
   the ray's angle, atan2(u - cx, fx); then the (candidate, class) pairs
   whose score sigmoid(class) x sigmoid(centerness) passes ``SCORE_THR``,
   the decode's first host sync, which waits for the forward on the card.
3. Span ``decode.nms``: class-wise rotated NMS over the bird's-eye view
   (x, z, size 0, size 2, -yaw) of those pairs: in each
   image and class, by descending score, a box is dropped where a kept box
   of higher rank overlaps it by an IoU over ``NMS_THR``.  The greedy
   visit is computed as the fixed point of "kept unless a kept box of
   higher rank overlaps it", from "all kept": the fixed point is unique and
   equals the greedy's, and each round fixes at least one more rank, so the
   rounds are as many as the longest chain of suppressions (a host sync
   each).  IoUs are computed (``ops/rotated_iou.py::bev_iou_pairs``) only
   for pairs whose circumscribed circles meet and whose areas are within
   ``NMS_THR`` of each other, the others' IoU being under the threshold.
   Then each image keeps its ``MAX_PER_IMG`` best.  Counters
   ``decode.nms_candidates`` (the pairs above the score threshold) and
   ``decode.nms_kept``.

Returns rows (B, MAX_PER_IMG, ``ROW``) in descending score, [x, y, z,
size 0-2, yaw, vx, vz, score, class, attribute] with (x, y, z) the box's
bottom centre in the camera frame, their validity (B, MAX_PER_IMG), and
extras: ``candidates`` (B, N, channels), the head values the decode read,
``locations`` (B, N), each candidate's index over the levels' locations
(level by level, row-major), and ``kept`` (B, MAX_PER_IMG), each row's
candidate (-1 where invalid).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..models.heads.fcos3d import FIELDS, STRIDES
from ..ops.rotated_iou import bev_iou_pairs
from ..utils import trace

# mmdetection3d's test_cfg for FCOS3D on nuScenes
NMS_PRE = 1000            # top locations a level and image
SCORE_THR = 0.05
NMS_THR = 0.8             # class-wise rotated BEV IoU
MAX_PER_IMG = 200
DIR_OFFSET = 0.7854       # the direction classifier's yaw offset

ROW = 12
PAIR_BUDGET = 1 << 24     # box pairs the NMS's circle and area test takes at once
X, Y, Z, SIZE, YAW = 0, 1, 2, 3, 6     # columns of a candidate's box


def limit_period(val: torch.Tensor, offset: float = 0.0, period: float = math.pi) -> torch.Tensor:
    return val - torch.floor(val / period + offset) * period


class FCOS3DDecoder:
    """The decode at the module's settings (module docstring)."""

    def __call__(self, maps: List[torch.Tensor], batch: Dict[str, torch.Tensor],
                 output_depth: Optional[str] = None):
        with trace.span("decode.topk"):
            cand, loc, points, stride = self.candidates(maps)
            boxes, scores, attr = self.boxes(cand, points, stride, batch["cam_intrinsic"])
            # the pairs over the threshold: the first wait on the device
            pairs = (scores > SCORE_THR).nonzero(as_tuple=True)
        with trace.span("decode.nms"):
            rows, valid, kept = self.nms(boxes, scores, attr, pairs)
        return rows, valid, {"candidates": cand, "locations": loc, "kept": kept}

    def candidates(self, maps: List[torch.Tensor]):
        """(candidates (B, N, ch), locations (B, N), points (B, N, 2), strides (N,))."""
        F = FIELDS
        cands, locs, points, strides = [], [], [], []
        base = 0
        for m, s in zip(maps, STRIDES):
            B, ch, H, W = m.shape
            flat = m.permute(0, 2, 3, 1).reshape(B, H * W, ch)
            score = (flat[..., F["cls"]].sigmoid() * flat[..., F["centerness"]].sigmoid()).amax(-1)
            k = min(NMS_PRE, H * W)
            idx = score.topk(k, dim=1).indices
            cands.append(flat.gather(1, idx[..., None].expand(B, k, ch)))
            locs.append(idx + base)
            points.append(torch.stack([idx % W, idx // W], -1) * s + s // 2)
            strides.append(torch.full((k,), float(s), device=m.device))
            base += H * W
        return (torch.cat(cands, 1), torch.cat(locs, 1), torch.cat(points, 1).float(),
                torch.cat(strides))

    def boxes(self, cand: torch.Tensor, points: torch.Tensor, stride: torch.Tensor,
              cam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(boxes (B, N, 9) [x, y, z (the centre), size 0-2, yaw, vx, vz],
        scores (B, N, classes), attributes (B, N))."""
        F = FIELDS
        cam = cam.float()
        fx, fy = cam[:, 0, 0, None], cam[:, 1, 1, None]
        cx, cy = cam[:, 0, 2, None], cam[:, 1, 2, None]
        centre = points - cand[..., F["offset"]] * stride[:, None]
        depth = cand[..., F["depth"]][..., 0].exp()
        size = cand[..., F["size"]].exp()
        u, v = centre[..., 0], centre[..., 1]
        x, y = (u - cx) * depth / fx, (v - cy) * depth / fy
        direction = cand[..., F["dir"]].argmax(-1)
        rot = limit_period(cand[..., F["rot"]][..., 0] - DIR_OFFSET)
        yaw = rot + DIR_OFFSET + math.pi * direction + torch.atan2(u - cx, fx)
        boxes = torch.cat([torch.stack([x, y, depth], -1), size, yaw[..., None],
                           cand[..., F["velo"]]], -1)
        scores = cand[..., F["cls"]].sigmoid() * cand[..., F["centerness"]].sigmoid()
        return boxes, scores, cand[..., F["attr"]].argmax(-1)

    def nms(self, boxes: torch.Tensor, scores: torch.Tensor, attr: torch.Tensor, pairs):
        """Rows, validity and kept candidates from ``pairs``, the (image,
        candidate, class) indices whose score passes the threshold."""
        B, N, C = scores.shape
        dev = boxes.device
        rows = torch.zeros(B, MAX_PER_IMG, ROW, device=dev)
        valid = torch.zeros(B, MAX_PER_IMG, dtype=torch.bool, device=dev)
        kept_cand = torch.full((B, MAX_PER_IMG), -1, dtype=torch.long, device=dev)
        b, n, c = pairs
        trace.add("decode.nms_candidates", b.numel())
        if b.numel() == 0:
            return rows, valid, kept_cand
        s = scores[b, n, c]
        order = torch.argsort(s, descending=True, stable=True)
        order = order[torch.argsort((b * C + c)[order], stable=True)]
        b, n, c, s = b[order], n[order], c[order], s[order]
        keep = self.greedy(boxes[b, n], b * C + c, B * C)
        b, n, c, s = b[keep], n[keep], c[keep], s[keep]
        # each image's best, in descending score
        order = torch.argsort(s, descending=True, stable=True)
        order = order[torch.argsort(b[order], stable=True)]
        b, n, c, s = b[order], n[order], c[order], s[order]
        counts = torch.bincount(b, minlength=B)
        rank = torch.arange(b.numel(), device=dev) - (counts.cumsum(0) - counts)[b]
        sel = rank < MAX_PER_IMG
        b, n, c, s, rank = b[sel], n[sel], c[sel], s[sel], rank[sel]
        box = boxes[b, n]
        bottom = box[:, Y] + box[:, SIZE + 1] / 2
        rows[b, rank] = torch.cat([box[:, X:Y], bottom[:, None], box[:, Z:], s[:, None],
                                   c[:, None].float(), attr[b, n][:, None].float()], -1)
        valid[b, rank] = True
        kept_cand[b, rank] = n
        trace.add("decode.nms_kept", b.numel())
        return rows, valid, kept_cand

    def greedy(self, boxes: torch.Tensor, group: torch.Tensor, n_groups: int) -> torch.Tensor:
        """The kept mask of the P candidates (P, 9), sorted by group and
        then by descending score (module docstring, step 3)."""
        P, dev = boxes.shape[0], boxes.device
        counts = torch.bincount(group, minlength=n_groups)
        starts = counts.cumsum(0) - counts
        rank = torch.arange(P, device=dev) - starts[group]
        m = int(counts.max())
        table = torch.full((n_groups, m), -1, dtype=torch.long, device=dev)
        table[group, rank] = torch.arange(P, device=dev)
        bev = torch.stack([boxes[:, X], boxes[:, Z], boxes[:, SIZE], boxes[:, SIZE + 2],
                           -boxes[:, YAW]], -1)
        radius = 0.5 * torch.hypot(bev[:, 2], bev[:, 3])
        area = bev[:, 2] * bev[:, 3]
        ar = torch.arange(m, device=dev)
        upper = ar[:, None] < ar[None, :]
        pi, pj = [], []
        step = max(1, PAIR_BUDGET // (m * m))
        for g0 in range(0, n_groups, step):
            t = table[g0:g0 + step]
            i, j = t[:, :, None], t[:, None, :]
            ii, jj = i.clamp(min=0), j.clamp(min=0)
            near = ((bev[ii, 0] - bev[jj, 0]).square() + (bev[ii, 1] - bev[jj, 1]).square()
                    < (radius[ii] + radius[jj]).square())
            similar = (torch.minimum(area[ii], area[jj])
                       > NMS_THR * torch.maximum(area[ii], area[jj]))
            g, a, z = (near & similar & (i >= 0) & (j >= 0) & upper).nonzero(as_tuple=True)
            pi.append(t[g, a])
            pj.append(t[g, z])
        pi, pj = torch.cat(pi), torch.cat(pj)
        keep = torch.ones(P, dtype=torch.bool, device=dev)
        if pi.numel() == 0:
            return keep
        over = bev_iou_pairs(bev[pi], bev[pj]) > NMS_THR
        pi, pj = pi[over], pj[over]
        while True:
            hits = torch.zeros(P, dtype=torch.int32, device=dev).index_add_(
                0, pj, keep[pi].int())
            new = hits == 0
            if torch.equal(new, keep):
                return keep
            keep = new
