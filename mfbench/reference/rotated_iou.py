"""3D IoU of matched box pairs (counterpart of ``iou_3d_pairs`` in
``monoflex_tpu/ops/rotated_iou.py``), for the training log only (no gradient).

Exact convex clipping (Sutherland-Hodgman) over fixed-size vertex buffers,
batched over pairs: the same vertex buffer, the same emit order and the same
degenerate-edge guard as the JAX version, so the two agree to rounding.
"""

from __future__ import annotations

import torch

_VMAX = 16  # the intersection of two convex quads has at most 8 vertices


def _clip_by_halfplane(poly: torch.Tensor, count: torch.Tensor, p1: torch.Tensor,
                       p2: torch.Tensor):
    """Clip each polygon (N, VMAX, 2) with ``count`` valid vertices by the
    half-plane left of its directed edge p1 -> p2 (N, 2)."""
    n = poly.shape[0]
    rows = torch.arange(n, device=poly.device)
    edge = p2 - p1

    def side(pt):
        d = pt - p1
        return edge[:, 0] * d[:, 1] - edge[:, 1] * d[:, 0]

    # one slot past the buffer takes the writes the JAX scatter would drop
    out = poly.new_zeros(n, _VMAX + 1, 2)
    m = torch.zeros(n, dtype=torch.long, device=poly.device)

    def emit(m, where, value):
        slot = m.clamp(max=_VMAX)
        out[rows, slot] = torch.where(where[:, None], value, out[rows, slot])
        return m + where.long()

    for i in range(_VMAX):
        cur = poly[:, i]
        nxt = poly[rows, torch.where(i + 1 >= count, 0, i + 1)]
        s_cur, s_nxt = side(cur), side(nxt)
        denom = s_cur - s_nxt
        t = torch.where(denom.abs() < 1e-12, torch.zeros_like(denom),
                        s_cur / torch.where(denom == 0, torch.ones_like(denom), denom))
        live = i < count
        m = emit(m, (s_cur >= 0) & live, cur)
        m = emit(m, ((s_cur >= 0) != (s_nxt >= 0)) & live, cur + (nxt - cur) * t[:, None])
    return out[:, :_VMAX], m


def _polygon_area(poly: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Shoelace area over the first ``count`` vertices of each polygon."""
    idx = torch.arange(_VMAX, device=poly.device)
    nxt = torch.where(idx + 1 >= count[:, None], 0, idx + 1)                 # (N, VMAX)
    x, y = poly[..., 0], poly[..., 1]
    contrib = x * y.gather(1, nxt) - x.gather(1, nxt) * y
    return 0.5 * torch.where(idx < count[:, None], contrib, 0.0).sum(dim=1).abs()


def _intersection_area(quad_a: torch.Tensor, quad_b: torch.Tensor) -> torch.Tensor:
    """Intersection area of convex quads (N, 4, 2), either winding."""

    def orient_ccw(q):
        s = (q[..., 0] * q[..., 1].roll(-1, 1) - q[..., 0].roll(-1, 1) * q[..., 1]).sum(dim=1)
        return torch.where((s < 0)[:, None, None], q.flip(1), q)

    a, b = orient_ccw(quad_a), orient_ccw(quad_b)
    poly = a.new_zeros(a.shape[0], _VMAX, 2)
    poly[:, :4] = a
    count = torch.full((a.shape[0],), 4, dtype=torch.long, device=a.device)
    for i in range(4):
        poly, count = _clip_by_halfplane(poly, count, b[:, i], b[:, (i + 1) % 4])
    return _polygon_area(poly, count)


@torch.no_grad()
def iou_3d_pairs(pred_corners: torch.Tensor, target_corners: torch.Tensor) -> torch.Tensor:
    """(N,) 3D IoU of matched 8-corner boxes (N, 8, 3) in rect camera coords
    (y down; corners 0-3 bottom, 4-7 top)."""
    A, B = pred_corners, target_corners
    min_h_a, max_h_a = -A[:, 0:4, 1].mean(dim=1), -A[:, 4:8, 1].mean(dim=1)
    min_h_b, max_h_b = -B[:, 0:4, 1].mean(dim=1), -B[:, 4:8, 1].mean(dim=1)
    h_overlap = (torch.minimum(max_h_a, max_h_b) - torch.maximum(min_h_a, min_h_b)).clamp(min=0)

    bev_a, bev_b = A[:, 0:4][..., [0, 2]], B[:, 0:4][..., [0, 2]]
    # the pair's overlap and each box's own area (its self-intersection, as
    # the JAX version takes it) in one batched clip
    n = A.shape[0]
    areas = _intersection_area(torch.cat([bev_a, bev_a, bev_b]), torch.cat([bev_b, bev_a, bev_b]))
    inter_bev, area_a, area_b = areas[:n], areas[n:2 * n], areas[2 * n:]
    overlap3d = inter_bev * h_overlap
    union3d = area_a * (max_h_a - min_h_a) + area_b * (max_h_b - min_h_b) - overlap3d
    return overlap3d / union3d.clamp(min=1e-7)
