"""Deformable position-sensitive ROI pooling (DCN PSROI), a plain torch op
(counterpart of ``monoflex_tpu/ops/psroi.py``, which is XLA, no Pallas;
reference: model/backbone/DCNv2/dcn_v2.py:132-303).  The reference exposes
it and MonoFlex does not call it; autograd gives its gradients.

rois: (N, 5) rows [batch_index, x1, y1, x2, y2] in input pixels.
x: (B, H, W, C) NHWC.  Output: (N, pooled, pooled, output_dim).
"""

from __future__ import annotations

from typing import Optional

import torch


def bilinear_gather(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) sampled bilinearly at float positions ys, xs (B, M):
    (B, M, C); a corner off the map contributes zero."""
    B, H, W, C = x.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    flat = x.reshape(B, H * W, C)
    out = None
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = y0 + dy, x0 + dx
        w = (wy if dy else 1.0 - wy) * (wx if dx else 1.0 - wx)
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        g = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], C))
        contrib = g * (w * valid.to(x.dtype))[..., None]
        out = contrib if out is None else out + contrib
    return out


def deform_psroi_pooling(x: torch.Tensor, rois: torch.Tensor,
                         trans: Optional[torch.Tensor] = None, spatial_scale: float = 1.0,
                         output_dim: int = 1, group_size: int = 1, pooled_size: int = 7,
                         sample_per_part: int = 4, trans_std: float = 0.1) -> torch.Tensor:
    """Position-sensitive ROI pooling with optional learned part offsets:
    ``trans`` (N, pooled, pooled, 2) shifts each part bin by (dx, dy) in
    units of the roi's size times ``trans_std``; None: no deformation."""
    B, H, W, C = x.shape
    N = rois.shape[0]
    P, S = pooled_size, sample_per_part
    if C != output_dim * group_size * group_size:
        raise ValueError(f"channels {C} != output_dim * group_size^2")
    dev = x.device
    batch_idx = rois[:, 0].long()
    # the roi's corners, shifted and rounded as the reference kernel does
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(x2 - x1, min=0.1)
    roi_h = torch.clamp(y2 - y1, min=0.1)
    bin_w, bin_h = roi_w / P, roi_h / P
    if trans is None:
        dxy = torch.zeros(N, P, P, 2, device=dev, dtype=x.dtype)
    else:
        dxy = trans * trans_std * torch.stack([roi_w, roi_h], dim=1)[:, None, None, :]
    # part (pj, pi) takes S x S points: (N, P, P, S, S)
    pj, pi = torch.meshgrid(torch.arange(P, device=dev), torch.arange(P, device=dev),
                            indexing="ij")
    sj, si = torch.meshgrid(torch.arange(S, device=dev), torch.arange(S, device=dev),
                            indexing="ij")

    def col(v):
        return v[:, None, None, None, None]

    ys = (col(y1) + pj[None, :, :, None, None] * col(bin_h)
          + (sj[None, None, None] + 0.5) * col(bin_h) / S + dxy[..., 1][..., None, None])
    xs = (col(x1) + pi[None, :, :, None, None] * col(bin_w)
          + (si[None, None, None] + 0.5) * col(bin_w) / S + dxy[..., 0][..., None, None])
    sampled = bilinear_gather(x[batch_idx], ys.reshape(N, -1), xs.reshape(N, -1))
    sampled = sampled.reshape(N, P, P, S, S, C)
    # part (pj, pi) reads channel group (gj, gi), g = floor(part / P * group_size);
    # channel c = group * output_dim + od
    group = (pj * group_size // P) * group_size + (pi * group_size // P)
    chan = group[..., None] * output_dim + torch.arange(output_dim, device=dev)
    chan = chan[None, :, :, None, None, :].expand(N, P, P, S, S, output_dim)
    return torch.gather(sampled, -1, chan).mean(dim=(3, 4))
