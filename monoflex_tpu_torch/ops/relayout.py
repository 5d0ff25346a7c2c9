"""The padded NHWC -> (B, H, Cs, wp2f) relayout of the TPU's transpose
ablation (``tools/transpose_ablate.py``): its Hopper kernel
(``csrc/relayout.cu``), the plain PyTorch version and the identity-matmul
staging.

    out[b, h, c, P + w] = x[b, h, w, c], zeros elsewhere

with Cs = C rounded up to 8, wp2f = roundup(roundup(W, 128) + 2P, 128) and
P = R + 1 (``relayout_dims``, the JAX tool's ``_dims``).  The TPU kernels
``pallas_variant`` and ``pallasT_variant`` compute this function on the core
rows; ``relayout`` is the wrapper of the kernel that replaces both.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .dcn_cuda import _check_device, _launch

_INT32_MAX = 2**31 - 1
_GRID_Z_MAX = 65535


def relayout_dims(H: int, W: int, C: int, R: int) -> Tuple[int, int, int, int]:
    """(P, wp, wp2f, Cs): the halo, W padded to 128, the padded row width and
    the channels padded to 8 (``tools/transpose_ablate.py::_dims``)."""
    P = R + 1
    wp = W + (-W) % 128
    wp2f = wp + 2 * P
    wp2f = wp2f + (-wp2f) % 128
    Cs = C + (-C) % 8
    return P, wp, wp2f, Cs


def _padded(x: torch.Tensor, R: int, row_halo: bool) -> torch.Tensor:
    """x padded to (B, H [+ 2P], wp2f, Cs), x at column offset P."""
    B, H, W, C = x.shape
    P, _, wp2f, Cs = relayout_dims(H, W, C, R)
    rows = (P, P) if row_halo else (0, 0)
    return F.pad(x, (0, Cs - C, P, wp2f - W - P) + rows)


def relayout_reference(x: torch.Tensor, R: int = 2, row_halo: bool = False) -> torch.Tensor:
    """The plain version: pad, then swap W and C (the JAX tool's ``xla``
    variant with ``row_halo``, its core rows without)."""
    return _padded(x, R, row_halo).permute(0, 1, 3, 2).contiguous()


def relayout_dot(x: torch.Tensor, R: int = 2) -> torch.Tensor:
    """The JAX tool's ``dot`` variant: pad (rows too), then an einsum with
    the identity that emits the transposed layout."""
    xt = _padded(x, R, row_halo=True)
    eye = torch.eye(xt.shape[-1], dtype=x.dtype, device=x.device)
    return torch.einsum("bhwc,cd->bhdw", xt, eye)


def relayout(x: torch.Tensor, R: int = 2) -> torch.Tensor:
    """(B, H, Cs, wp2f) float32 of x (B, H, W, C) float32, the core rows of
    the relayout.  A CUDA tensor launches ``csrc/relayout.cu`` (counted in
    ``relayout.launches``); a CPU tensor runs ``relayout_reference``."""
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 (B,H,W,C), got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return relayout_reference(x, R)
    _check_device("relayout", x)
    if not x.is_contiguous():
        raise ValueError("relayout: x must be contiguous")
    B, H, W, C = x.shape
    P, _, wp2f, Cs = relayout_dims(H, W, C, R)
    if B * H > _GRID_Z_MAX or B * H * max(W * C, Cs * wp2f) > _INT32_MAX:
        raise ValueError(f"relayout: shape {tuple(x.shape)} exceeds the kernel's grid or "
                         f"32-bit indices")
    out = torch.empty((B, H, Cs, wp2f), device=x.device, dtype=torch.float32)
    _launch("relayout", x, x.data_ptr(), out.data_ptr(), B, H, W, C, Cs, wp2f, P)
    relayout.launches += 1
    return out


relayout.launches = 0
