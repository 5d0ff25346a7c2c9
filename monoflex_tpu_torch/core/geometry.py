"""The geometry codec (counterpart of ``monoflex_tpu/core/geometry_jax.py``):
batched, fixed-shape tensor math on packed intrinsics ``calib_params`` =
[f_u f_v c_u c_v b_x b_y] per row.  The decode half serves inference, the
encode half (``rad_to_matrix``, ``encode_box3d``) the losses."""

from __future__ import annotations

import math
from typing import Dict, Hashable, Optional, Sequence

import torch

PI = math.pi
ALPHA_CENTERS = (0.0, PI / 2, PI, -PI / 2)

# corner c of a box takes column _CORNER_INDEX[r][c] of the (+half x4,
# -half x4) table for axis r (x from l, y from h, z from w): corners 0-3 are
# the bottom face, 4-7 the top
_CORNER_INDEX = ((4, 5, 0, 1, 6, 7, 2, 3),
                 (0, 1, 2, 3, 4, 5, 6, 7),
                 (4, 0, 1, 5, 6, 2, 3, 7))

_CONSTANTS: Dict[Hashable, torch.Tensor] = {}


def device_constant(values: Sequence, device: torch.device,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype)`` on ``device``, uploaded once and
    kept (``values`` a tuple, nested for more dims): an upload from the
    host waits for the device's queue, and a CUDA graph cannot capture it.
    Made outside inference mode, so that autograd may save it."""
    key = (values, dtype, device)
    table = _CONSTANTS.get(key)
    if table is None:
        with torch.inference_mode(False):
            table = _CONSTANTS[key] = torch.tensor(values, dtype=dtype).to(device)
    return table


def rad_to_matrix(rotys: torch.Tensor) -> torch.Tensor:
    """(N,) yaw -> (N, 3, 3) rotation about the camera Y axis."""
    cos, sin = torch.cos(rotys), torch.sin(rotys)
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    return torch.stack([torch.stack([cos, zeros, sin], dim=-1),
                        torch.stack([zeros, ones, zeros], dim=-1),
                        torch.stack([-sin, zeros, cos], dim=-1)], dim=-2)


def encode_box3d(rotys: torch.Tensor, dims: torch.Tensor, locs: torch.Tensor) -> torch.Tensor:
    """(N,) yaw, (N, 3) dims (l, h, w), (N, 3) 3D centers -> (N, 8, 3)
    corners in rect coords."""
    rotys = rotys.reshape(-1)
    half = dims.reshape(-1, 3) * 0.5
    plus_minus = torch.cat([half[..., None].expand(-1, 3, 4),
                            -half[..., None].expand(-1, 3, 4)], dim=-1)     # (N, 3, 8)
    index = device_constant(_CORNER_INDEX, plus_minus.device)
    box_obj = plus_minus.gather(2, index.expand(plus_minus.shape[0], 3, 8))
    corners = rad_to_matrix(rotys) @ box_obj + locs.reshape(-1, 3)[..., None]
    return corners.transpose(1, 2)

def decode_depth(depths_offset: torch.Tensor, mode: str = "inv_sigmoid",
                 depth_ref: Sequence[float] = (26.494627, 16.05988),
                 depth_range: Optional[Sequence[float]] = (0.1, 100.0)) -> torch.Tensor:
    """Depth head output -> metric depth."""
    if mode == "exp":
        depth = torch.exp(depths_offset)
    elif mode == "linear":
        depth = depths_offset * depth_ref[1] + depth_ref[0]
    elif mode == "inv_sigmoid":
        depth = 1.0 / torch.sigmoid(depths_offset) - 1.0
    else:
        raise ValueError(f"unknown depth mode {mode}")
    if depth_range is not None:
        depth = depth.clamp(depth_range[0], depth_range[1])
    return depth


def project_image_to_rect(points_uv: torch.Tensor, depths: torch.Tensor,
                          calib_params: torch.Tensor) -> torch.Tensor:
    """Pinhole back-projection of (N, 2) original-image pixels at (N,) depths."""
    f_u, f_v, c_u, c_v, b_x, b_y = calib_params.unbind(1)
    x = (points_uv[:, 0] - c_u) * depths / f_u + b_x
    y = (points_uv[:, 1] - c_v) * depths / f_v + b_y
    return torch.stack([x, y, depths], dim=1)


def decode_location(points: torch.Tensor, offsets: torch.Tensor, depths: torch.Tensor,
                    calib_params: torch.Tensor, pad_size: torch.Tensor,
                    down_ratio: int = 4) -> torch.Tensor:
    """Feature-map peak + offset + depth -> 3D location (rect coords)."""
    uv = (points + offsets) * down_ratio - pad_size
    return project_image_to_rect(uv, depths, calib_params)


def decode_depth_from_keypoints(keypoints: torch.Tensor, dims: torch.Tensor,
                                calib_params: torch.Tensor, down_ratio: int = 4,
                                depth_range: Sequence[float] = (0.1, 100.0),
                                eps: float = 1e-3) -> torch.Tensor:
    """Keypoint-triangulated depths (N, 3): [center pair, diagonal 02,
    diagonal 13]; keypoints (N, 10, 2) in feature pixels."""
    f_u = calib_params[:, 0]
    height_3d = dims[:, 1]

    center_h = keypoints[:, 8, 1] - keypoints[:, 9, 1]
    # keypoints 0, 2 less 4, 6 and 1, 3 less 5, 7, by slices: an index list is
    # uploaded from the host, which waits for the device's queue
    corner_02_h = keypoints[:, 0:4:2, 1] - keypoints[:, 4:8:2, 1]
    corner_13_h = keypoints[:, 1:4:2, 1] - keypoints[:, 5:8:2, 1]

    def h2d(hh):
        return torch.relu(hh) * down_ratio + eps

    center_depth = f_u * height_3d / h2d(center_h)
    corner_02_depth = (f_u * height_3d)[:, None] / h2d(corner_02_h)
    corner_13_depth = (f_u * height_3d)[:, None] / h2d(corner_13_h)
    depths = torch.stack([center_depth, corner_02_depth.mean(dim=1),
                          corner_13_depth.mean(dim=1)], dim=1)
    return depths.clamp(depth_range[0], depth_range[1])


def decode_dimension(cls_ids: torch.Tensor, dims_offset: torch.Tensor,
                     dim_mean: torch.Tensor, dim_std: torch.Tensor,
                     mode: str = "exp", use_std: bool = False) -> torch.Tensor:
    """Class-conditioned dimension decode, (N, 3) as (l, h, w)."""
    cls_ids = cls_ids.reshape(-1).long().clamp(0, dim_mean.shape[0] - 1)
    mean = dim_mean[cls_ids]
    if mode == "exp":
        dims_offset = torch.exp(dims_offset)
    if use_std:
        return dims_offset * dim_std[cls_ids] + mean
    return dims_offset * mean


def _wrap(angle: torch.Tensor) -> torch.Tensor:
    angle = torch.where(angle > PI, angle - 2 * PI, angle)
    return torch.where(angle < -PI, angle + 2 * PI, angle)


def decode_axes_orientation(vector_ori: torch.Tensor, locations: torch.Tensor,
                            num_bin: int = 4):
    """Multibin head output + location -> (roty, alpha), both in [-pi, pi].
    vector_ori: (N, 4*num_bin) = [bin logits (2/bin), sin/cos (2/bin)]."""
    n = vector_ori.shape[0]
    logits = vector_ori[:, :num_bin * 2].reshape(n, num_bin, 2)
    best = torch.softmax(logits, dim=2)[..., 1].argmax(dim=1)           # (N,)
    sincos = vector_ori[:, num_bin * 2:].reshape(n, num_bin, 2)
    chosen = sincos[torch.arange(n, device=vector_ori.device), best]
    centers = device_constant(ALPHA_CENTERS, vector_ori.device, vector_ori.dtype)
    alphas = torch.atan2(chosen[:, 0], chosen[:, 1]) + centers[best]
    locations = locations.reshape(-1, 3)
    rotys = alphas + torch.atan2(locations[:, 0], locations[:, 2])
    return _wrap(rotys), _wrap(alphas)


def decode_box2d_fcos(centers: torch.Tensor, pred_offset: torch.Tensor,
                      pad_size: Optional[torch.Tensor] = None,
                      out_size: Optional[torch.Tensor] = None,
                      down_ratio: int = 4) -> torch.Tensor:
    """FCOS-style l/t/r/b offsets -> absolute 2D boxes, optionally scaled to
    the original image and clamped to it."""
    box2d = torch.cat([centers - pred_offset[:, :2], centers + pred_offset[:, 2:]], dim=1)
    if pad_size is not None:
        box2d = box2d * down_ratio - pad_size.repeat(1, 2)
        w = out_size[:, 0]
        h = out_size[:, 1]
        zero = torch.zeros_like(w)
        box2d = torch.stack([
            torch.minimum(torch.maximum(box2d[:, 0], zero), w - 1),
            torch.minimum(torch.maximum(box2d[:, 1], zero), h - 1),
            torch.minimum(torch.maximum(box2d[:, 2], zero), w - 1),
            torch.minimum(torch.maximum(box2d[:, 3], zero), h - 1),
        ], dim=1)
    return box2d
