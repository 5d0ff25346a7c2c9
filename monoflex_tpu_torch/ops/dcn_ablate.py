"""Ablations of the DCNv2 forward: the functions the TPU diagnostics tools
strip the forward kernel to (``tools/kernel_diag.py`` and
``tools/fwd_ablate.py``), each as a plain PyTorch version and as one variant
of the Hopper kernel ``csrc/dcn_ablate.cu``, which keeps one part of
``dcn_fwd`` as it runs on the card (its halo staging, its sampling producer,
or its own ring of split-bf16 products on the tensor cores,
``csrc/fwd_stages.cuh``, with another A-tile producer) so that its time is
a part of ``dcn_fwd``'s.

With x (B,H,W,C) NHWC float32 and zero padding outside the map, R the offset
clamp, o_k and m_k the tap's offset and mask (layouts as ``ops/dcn.py``) and
hat(t) = max(0, 1 - |t|):

- ``dma``: x itself, copied through a staged halo tile (C out channels);
- ``window``: sum_k bil(x, p + (ky,kx) + clip(o_k)), no mask, no W (C);
- ``aligned``: sum_k sum_dy hat(oy_k + ky - dy) x[h + dy, w], the window with
  its column shifts dropped (C);
- ``matmul``: sum_k m_k x[p + (ky,kx)] W_k, a modulated 3x3 conv with no
  offsets (Co);
- ``nomap``: sum_k 0.25 (sum_{e,f in [-R,R]} x[h+ky+e, w+kx+f]) W_k (Co);
- ``nobcast``: the (2R+1)^2 hat window with each hat map replaced by its
  maximum over the row tile of ``pick_tile_h(H)`` rows x W, padded rows with
  offset 0 and mask 0 (Co).

``dcn_ablate`` launches the kernel on CUDA tensors (``dcn_ablate.launches``
counts calls per variant) and runs ``dcn_ablate_reference`` on CPU tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .dcn import bilinear_columns, check_dcn_inputs
from .dcn_cuda import (FWD_PARTS, _check_device, _check_kernel_operands, _launch, fwd_image_numel,
                       fwd_tile_n)

VARIANTS = ("dma", "window", "aligned", "matmul", "nomap", "nobcast")
_CODES = {v: i for i, v in enumerate(VARIANTS)}   # the kernel's Variant enum
C_OUT = ("dma", "window", "aligned")              # out channels C, not Co
GEMM = ("matmul", "nomap", "nobcast")             # the variants with dcn_fwd's products
# the TPU tools' guard band: 8 rows above and below a staged tile, which
# P = R + 1 must fit, so R <= 7 (the kernel takes the same range)
_GUARD = 8
R_MAX = _GUARD - 1
# the variants whose A tile comes from a halo of x in shared memory: they take
# 64 output channels a block (csrc/dcn_ablate.cu gemm_window_kernel)
WINDOW = ("nomap", "nobcast")


def pick_tile_h(H: int) -> int:
    """The v2 TPU kernel's row tile (``monoflex_tpu/ops/dcn_pallas_v2.py::
    _pick_tile_h``): the whole map padded to 16 rows up to H = 32, else 16."""
    if H <= 32:
        return 16 * max(1, -(-H // 16))
    return 16


def ablate_tile_n(variant: str, Co: int) -> int:
    """Output channels a block of ``variant``'s products takes: dcn_fwd's
    tile (``fwd_tile_n``) for matmul, 64 for nomap and nobcast, whose halo
    of x does not fit beside dcn_fwd's wider rings."""
    return 64 if variant in WINDOW else fwd_tile_n(Co)


def _hat(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - t.abs(), min=0.0)


def _window_product(x: torch.Tensor, weight: torch.Tensor, R: int, wy: torch.Tensor,
                    wx: torch.Tensor) -> torch.Tensor:
    """sum_k sum_e wy[..,k,e] sum_f wx[..,k,f] x[h+ky+e, w+kx+f] W_k, with wy
    and wx (B,H,1,9,2R+1) weights per row."""
    B, H, W, C = x.shape
    P = R + 1
    xp = F.pad(x, (0, 0, P, P, P, P))
    out = None
    for k in range(9):
        ky, kx = k // 3 - 1, k % 3 - 1
        s = torch.zeros_like(x)
        for e in range(-R, R + 1):
            t = torch.zeros_like(x)
            for f in range(-R, R + 1):
                rows = xp[:, P + ky + e: P + ky + e + H, P + kx + f: P + kx + f + W]
                t = t + rows * wx[..., k, f + R, None]
            s = s + t * wy[..., k, e + R, None]
        term = s @ weight[k // 3, k % 3]
        out = term if out is None else out + term
    return out


def _tile_maxima(offset: torch.Tensor, mask: torch.Tensor, R: int):
    """nobcast's hat maxima per (b, row tile, tap): wy (B,Hp/tile,9,2R+1) of
    hat(clip(oy) - e) m and wx of hat(clip(ox) - f), over tile_h x W pixels,
    the padded rows with offset 0 and mask 0."""
    B, H, W, _ = offset.shape
    tile_h = pick_tile_h(H)
    pad_h = (-H) % tile_h
    off = F.pad(offset, (0, 0, 0, 0, 0, pad_h)).clamp(-R, R)
    m = F.pad(mask, (0, 0, 0, 0, 0, pad_h))
    e = torch.arange(-R, R + 1, device=offset.device, dtype=torch.float32)
    wy = _hat(off[..., 0::2, None] - e) * m[..., None]                # (B,Hp,W,9,2R+1)
    wx = _hat(off[..., 1::2, None] - e)
    tiles = (B, (H + pad_h) // tile_h, tile_h * W, 9, 2 * R + 1)
    return (wy.reshape(tiles).amax(dim=2), wx.reshape(tiles).amax(dim=2), tile_h)


def dcn_ablate_reference(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                         weight: torch.Tensor, *, variant: str, max_offset: int) -> torch.Tensor:
    """The plain PyTorch version of ``variant`` (module docstring)."""
    R = int(max_offset)
    B, H, W, C = x.shape
    if variant == "dma":
        # the TPU kernel's staging: x in a halo of guard rows and P columns,
        # then its core
        P = R + 1
        return F.pad(x, (0, 0, P, P, _GUARD, _GUARD))[:, _GUARD:_GUARD + H, P:P + W].contiguous()
    if variant in ("window", "aligned"):
        k = torch.arange(9, device=x.device)
        hh = torch.arange(H, device=x.device, dtype=torch.float32).view(1, H, 1, 1)
        ww = torch.arange(W, device=x.device, dtype=torch.float32).view(1, 1, W, 1)
        py = hh + (k // 3 - 1) + offset[..., 0::2].clamp(-R, R)
        px = (ww + (k % 3 - 1) + offset[..., 1::2].clamp(-R, R) if variant == "window"
              else ww.expand(B, H, W, 9))
        return bilinear_columns(x, py, px, 1.0).sum(dim=3)
    if variant == "matmul":
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        out = None
        for k in range(9):
            dy, dx = k // 3, k % 3
            term = (xp[:, dy:dy + H, dx:dx + W] * mask[..., k, None]) @ weight[dy, dx]
            out = term if out is None else out + term
        return out
    if variant == "nomap":
        half = torch.full((1, 1, 1, 9, 2 * R + 1), 0.5, device=x.device)
        return _window_product(x, weight, R, half, half)
    if variant == "nobcast":
        wy, wx, tile_h = _tile_maxima(offset, mask, R)
        rows = torch.arange(H, device=x.device) // tile_h
        # each row's tile maxima, broadcast over its W pixels
        return _window_product(x, weight, R, wy[:, rows, None], wx[:, rows, None])
    raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def dcn_ablate(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               weight: torch.Tensor, *, variant: str, max_offset: int) -> torch.Tensor:
    """(B,H,W,C) for dma/window/aligned, (B,H,W,Co) for the others, float32;
    every operand float32 and checked as the DCN's, whichever the variant
    reads.  A CUDA tensor launches ``csrc/dcn_ablate.cu``; a CPU tensor runs
    ``dcn_ablate_reference``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    R = int(max_offset)
    if not 0 <= R <= R_MAX or R != max_offset:
        raise ValueError(f"max_offset must be an integer in [0, {R_MAX}], got {max_offset}")
    check_dcn_inputs(x, offset, mask, weight, None)
    if x.device.type == "cpu":
        return dcn_ablate_reference(x, offset, mask, weight, variant=variant, max_offset=R)
    _check_device("dcn_ablate", x)
    B, H, W, C = x.shape
    Co = weight.shape[3]
    _check_kernel_operands("dcn_ablate", B, H, W, C, Co, x=x, offset=offset, mask=mask,
                           weight=weight)
    tile_h = pick_tile_h(H)
    ntiles = math.ceil(H / tile_h)
    new = dict(device=x.device, dtype=torch.float32)
    tilemax = (torch.empty((B * ntiles * 9, 2, 2 * R + 1), **new) if variant == "nobcast"
               else None)
    # scratch for W's split and layout as dcn_fwd's, which the kernel writes first
    bn = ablate_tile_n(variant, Co)
    w_img = (torch.empty(fwd_image_numel(C, Co, bn), device=x.device, dtype=torch.bfloat16)
             if variant in GEMM else None)
    out = torch.empty((B, H, W, C if variant in C_OUT else Co), **new)
    _launch("dcn_ablate", x, _CODES[variant], x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), None if w_img is None else w_img.data_ptr(),
            None if tilemax is None else tilemax.data_ptr(), out.data_ptr(), FWD_PARTS, bn,
            B, H, W, C, Co, tile_h, ntiles, R)
    dcn_ablate.launches[variant] += 1
    return out


dcn_ablate.launches = {v: 0 for v in VARIANTS}
