"""3D IoU of matched box pairs (counterpart of ``iou_3d_pairs`` in
``monoflex_tpu/ops/rotated_iou.py``), for the training log only (no gradient),
and the IoU of rotated bird's-eye-view boxes, for FCOS3D's NMS
(``decode/fcos3d.py``).

Both rest on ``_intersection_area``: the exact intersection of two convex
quads by Green's theorem, in a fixed number of batched operations.  The
boundary of the intersection is the part of each quad's edges that lies
inside the other, so twice its area is the sum of cross(start, end) over
those parts.  The JAX version clips polygons (Sutherland-Hodgman); the two
agree to rounding.
"""

from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _orient_ccw(q: torch.Tensor) -> torch.Tensor:
    return torch.where((_cross(q, q.roll(-1, 1)).sum(1) < 0)[:, None, None], q.flip(1), q)


def _area(q: torch.Tensor) -> torch.Tensor:
    """Shoelace area of counter-clockwise quads (N, 4, 2)."""
    return 0.5 * _cross(q, q.roll(-1, 1)).sum(1)


def _edges_inside(p: torch.Tensor, q: torch.Tensor, first: bool) -> torch.Tensor:
    """Twice the signed area that the edges of p (N, 4, 2, counter-clockwise)
    add to the boundary of p and q's intersection: each edge clipped to
    convex q by its four half-planes (Cyrus-Beck), summed as cross(start,
    end) of the part inside.  An edge that lies on an edge of q and runs the
    same way is the same stretch of boundary: it counts in the ``first``
    call only.  (Running the other way, the two cancel, as they should.)"""
    a, b = p, p.roll(-1, 1)                                  # (N, 4, 2) edges a -> b
    d = b - a
    qe = q.roll(-1, 1) - q                                   # q's edges
    f0 = _cross(qe[:, None], a[:, :, None] - q[:, None])     # (N, 4 edges, 4 planes)
    df = _cross(qe[:, None], d[:, :, None].expand(-1, -1, 4, -1))
    t = -f0 / torch.where(df == 0, torch.ones_like(df), df)
    inf = torch.full_like(t, float("inf"))
    lo = torch.where(df > 0, t, -inf).amax(-1).clamp(min=0.0)
    hi = torch.where(df < 0, t, inf).amin(-1).clamp(max=1.0)
    parallel = df == 0
    outside = (parallel & (f0 < 0)).any(-1) | (hi <= lo)
    if not first:
        same_way = (qe[:, None] * d[:, :, None]).sum(-1) > 0
        outside |= (parallel & (f0 == 0) & same_way).any(-1)
    s0, s1 = a + lo[..., None] * d, a + hi[..., None] * d
    return torch.where(outside, torch.zeros_like(lo), _cross(s0, s1)).sum(-1)


def _intersection_area(quad_a: torch.Tensor, quad_b: torch.Tensor) -> torch.Tensor:
    """Intersection area of convex quads (N, 4, 2), either winding (module
    docstring), both moved by the first's centre so that the cross products
    stay small; clamped to [0, the smaller area]."""
    a, b = _orient_ccw(quad_a), _orient_ccw(quad_b)
    centre = a.mean(1, keepdim=True)
    a, b = a - centre, b - centre
    inter = 0.5 * (_edges_inside(a, b, True) + _edges_inside(b, a, False))
    return torch.minimum(inter.clamp(min=0.0), torch.minimum(_area(a), _area(b)))


@torch.no_grad()
def iou_3d_pairs(pred_corners: torch.Tensor, target_corners: torch.Tensor) -> torch.Tensor:
    """(N,) 3D IoU of matched 8-corner boxes (N, 8, 3) in rect camera coords
    (y down; corners 0-3 bottom, 4-7 top)."""
    A, B = pred_corners, target_corners
    min_h_a, max_h_a = -A[:, 0:4, 1].mean(dim=1), -A[:, 4:8, 1].mean(dim=1)
    min_h_b, max_h_b = -B[:, 0:4, 1].mean(dim=1), -B[:, 4:8, 1].mean(dim=1)
    h_overlap = (torch.minimum(max_h_a, max_h_b) - torch.maximum(min_h_a, min_h_b)).clamp(min=0)

    # (x, z) by a slice: an index list is uploaded from the host, which a
    # CUDA graph cannot capture
    bev_a, bev_b = A[:, 0:4, 0::2], B[:, 0:4, 0::2]
    inter_bev = _intersection_area(bev_a, bev_b)
    area_a, area_b = _area(_orient_ccw(bev_a)), _area(_orient_ccw(bev_b))
    overlap3d = inter_bev * h_overlap
    union3d = area_a * (max_h_a - min_h_a) + area_b * (max_h_b - min_h_b) - overlap3d
    return overlap3d / union3d.clamp(min=1e-7)


def bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) counter-clockwise corners of BEV boxes (..., 5) [x, z, dx,
    dz, r]: the box's dx along its local x, dz along its local z, turned by
    r from x towards z."""
    x, z, dx, dz, r = boxes.unbind(-1)
    c, s = torch.cos(r), torch.sin(r)
    u = torch.stack([dx, -dx, -dx, dx], -1) / 2
    v = torch.stack([dz, dz, -dz, -dz], -1) / 2
    return torch.stack([x[..., None] + c[..., None] * u - s[..., None] * v,
                        z[..., None] + s[..., None] * u + c[..., None] * v], -1)


@torch.no_grad()
def bev_iou_pairs(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N,) IoU of matched rotated BEV boxes (N, 5) [x, z, dx, dz, r]; the
    corners are taken about the first box's centre, so that they keep their
    precision far from the camera."""
    shift = torch.cat([boxes_a[:, :2], torch.zeros_like(boxes_a[:, 2:])], 1)
    inter = _intersection_area(bev_corners(boxes_a - shift), bev_corners(boxes_b - shift))
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    return inter / (area_a + area_b - inter).clamp(min=1e-12)
