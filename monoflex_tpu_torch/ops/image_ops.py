"""Image-space ops of the heads and the decoder (counterpart of
``monoflex_tpu/ops/image_ops.py``).

Maps are NCHW here.  Gathers and scatters go through the NHWC view
(``permute(0, 2, 3, 1)``), which is free for the channels-last tensors the
model produces.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def sigmoid_hm(logits: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    return torch.sigmoid(logits).clamp(eps, 1 - eps)


def nms_hm(heatmap: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only local maxima: x * (maxpool3x3(x) == x).  max_pool2d pads with
    -inf, as the JAX reduce_window does."""
    hmax = F.max_pool2d(heatmap, kernel, stride=1, padding=(kernel - 1) // 2)
    return heatmap * (hmax == heatmap).to(heatmap.dtype)


def select_topk(heatmap: torch.Tensor, k: int = 50
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-stage exact top-k over a (B, C, H, W) heatmap: k peaks per class,
    then k overall.  Returns (scores, flat_spatial_index, cls, ys, xs), each
    (B, k)."""
    B, C, H, W = heatmap.shape
    scores_all, inds_all = torch.topk(heatmap.reshape(B, C, H * W), k)   # (B, C, k)
    ys_all = (inds_all // W).float()
    xs_all = (inds_all % W).float()
    scores, inds = torch.topk(scores_all.reshape(B, C * k), k)           # (B, k)
    clses = (inds // k).float()

    def gather(t):
        return t.reshape(B, C * k).gather(1, inds)

    return scores, gather(inds_all), clses, gather(ys_all), gather(xs_all)


def select_point_of_interest(feature_map: Union[torch.Tensor, Sequence[torch.Tensor]],
                             index: torch.Tensor) -> torch.Tensor:
    """Gather per-object feature vectors at integer map locations.

    feature_map: (B, C, H, W), or a sequence of maps sharing (B, H, W) whose
    gathers concatenate on the channel axis.  index: (B, N, 2) [x, y] or
    (B, N) flat.  Returns (B, N, C).
    """
    if isinstance(feature_map, (list, tuple)):
        return torch.cat([select_point_of_interest(m, index) for m in feature_map], dim=-1)
    B, C, H, W = feature_map.shape
    if index.dim() == 3:
        index = index[..., 1] * W + index[..., 0]
    index = index.long().clamp(0, H * W - 1)
    rows = feature_map.permute(0, 2, 3, 1).reshape(B, H * W, C)
    return rows.gather(1, index[..., None].expand(B, index.shape[1], C))


def gather_edge_features(feature_map, edge_indices: torch.Tensor) -> torch.Tensor:
    """Features along the boundary pixel chain, (B, E, C).  The reference's
    grid_sample at integer coordinates is exactly this gather."""
    return select_point_of_interest(feature_map, edge_indices)


def scatter_add_edge(output: torch.Tensor, edge_indices: torch.Tensor,
                     edge_values: torch.Tensor, edge_len: torch.Tensor) -> torch.Tensor:
    """Add per-boundary-pixel values back onto the dense map.

    output: (B, C, H, W); edge_indices: (B, E, 2) [x, y]; edge_values:
    (B, E, C); edge_len: (B,) valid prefix lengths.  Duplicate indices
    accumulate.  Returns a new (B, C, H, W) map.
    """
    B, C, H, W = output.shape
    E = edge_indices.shape[1]
    valid = torch.arange(E, device=output.device)[None, :] < edge_len[:, None]
    vals = edge_values * valid[..., None].to(edge_values.dtype)
    flat = (edge_indices[..., 1] * W + edge_indices[..., 0]).long().clamp(0, H * W - 1)
    flat = flat + torch.arange(B, device=output.device)[:, None] * (H * W)
    rows = output.permute(0, 2, 3, 1).reshape(B * H * W, C).clone()
    rows.index_put_((flat.reshape(-1),), vals.reshape(-1, C).to(rows.dtype), accumulate=True)
    return rows.view(B, H, W, C).permute(0, 3, 1, 2)
