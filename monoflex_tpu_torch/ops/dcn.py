"""Modulated deformable 3x3 convolution (DCNv2), plain PyTorch.

The CPU path of the DCN and the oracle of the Hopper kernels
(``ops/dcn_cuda.py``): the forward, and its backward as the contract of
``monoflex_tpu/ops/dcn_pallas_v3.py::dcn_pallas_v3_bwd``.  Same contract as the JAX package's clamped DCN
(``monoflex_tpu/ops/dcn.py::modulated_deform_conv_shift`` and the Pallas
``dcn_pallas_v3``): each learned offset is clamped to [-R, R], the input is
sampled bilinearly at the 4 corners with zero padding, modulated by the mask
and contracted over the 9 taps x C channels.  The TPU kernels' (2R+1)^2 hat
window is exactly this bilinear sample at the clamped point.

Layouts follow the JAX op: x (B,H,W,C) NHWC; offset (B,H,W,18) interleaved
(dy_k, dx_k) for taps k = 3*(ky+1) + (kx+1); mask (B,H,W,9) post-sigmoid;
weight (3,3,C,Co).  Returns (B,H,W,Co) float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# (dy, dx) of the 4 bilinear corners
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def check_dcn_inputs(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                     weight: torch.Tensor, bias: Optional[torch.Tensor],
                     x_dtypes: Tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    """Raise ValueError unless the operands have the op's shapes and dtypes
    (x in one of ``x_dtypes``, everything else float32)."""
    if x.dim() != 4 or x.dtype not in x_dtypes:
        raise ValueError(f"x must be {x_dtypes} (B,H,W,C), got {x.dtype} {tuple(x.shape)}")
    B, H, W, C = x.shape
    expect = {"offset": (offset, (B, H, W, 18)), "mask": (mask, (B, H, W, 9))}
    if weight.dim() != 4 or tuple(weight.shape[:3]) != (3, 3, C):
        raise ValueError(f"weight must be (3,3,{C},Co), got {tuple(weight.shape)}")
    Co = weight.shape[3]
    expect["weight"] = (weight, (3, 3, C, Co))
    if bias is not None:
        expect["bias"] = (bias, (Co,))
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                          max_offset: int,
                          transfer_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """DCNv2 forward with offsets clamped to +-max_offset.

    transfer_dtype: x is rounded to this dtype before sampling (bf16 mirrors
    the TPU kernel's bf16-shipped x); the arithmetic is float32 either way, so
    the result equals the float32 op on the rounded x.  The rounding is
    straight-through for autograd: dx is the float32 gradient with respect to
    the rounded x, as the TPU backward returns it, not a bf16-rounded one.
    """
    check_dcn_inputs(x, offset, mask, weight, bias)
    B, H, W, C = x.shape
    Co = weight.shape[3]
    if transfer_dtype != torch.float32:
        # x + (round(x) - x) is exactly round(x): the difference of two
        # floats within a factor of 2 of each other is exact
        x = x + (x.to(transfer_dtype).float() - x).detach()
    R = float(max_offset)
    dev = x.device

    k = torch.arange(9, device=dev)
    ky = (k // 3 - 1).float()
    kx = (k % 3 - 1).float()
    py = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1, 1) + ky \
        + offset[..., 0::2].clamp(-R, R)                            # (B,H,W,9)
    px = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W, 1) + kx \
        + offset[..., 1::2].clamp(-R, R)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ly = py - y0
    lx = px - x0
    batch_base = torch.arange(B, device=dev).view(B, 1, 1, 1) * (H * W)

    x_rows = x.reshape(B * H * W, C)
    cols = None
    for dy, dx in _CORNERS:
        yi = y0 + dy
        xi = x0 + dx
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        wgt = (ly if dy else 1.0 - ly) * (lx if dx else 1.0 - lx) * inside * mask
        idx = batch_base + yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        term = x_rows.index_select(0, idx.reshape(-1)).view(B, H, W, 9, C) * wgt[..., None]
        cols = term if cols is None else cols + term
    out = (cols.reshape(B * H * W, 9 * C) @ weight.reshape(9 * C, Co)).view(B, H, W, Co)
    if bias is not None:
        out = out + bias
    return out


def check_epilogue(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor) -> None:
    """Raise ValueError unless scale and shift are float32 (Co,) on x's device."""
    Co = weight.shape[3]
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (Co,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be float32 ({Co},) on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def modulated_deform_conv_bn_relu(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                  weight: torch.Tensor, scale: torch.Tensor,
                                  shift: torch.Tensor, *, max_offset: int,
                                  transfer_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The DCN with the eval BN+ReLU epilogue, as ``dcn_pallas_v3(...,
    epilogue=(scale, shift))``: relu(DCN(x; no bias) * scale + shift).  The
    caller folds the BN and the conv bias into (scale, shift)."""
    check_dcn_inputs(x, offset, mask, weight, None)
    check_epilogue(x, weight, scale, shift)
    y = modulated_deform_conv(x, offset, mask, weight, None, max_offset=max_offset,
                              transfer_dtype=transfer_dtype)
    return torch.relu(y * scale + shift)


_WRT = ("x", "offset", "mask", "weight")


def modulated_deform_conv_backward(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                   weight: torch.Tensor, g: torch.Tensor, *, max_offset: int,
                                   transfer_dtype: torch.dtype = torch.float32,
                                   wrt: Tuple[str, ...] = _WRT):
    """The five gradients of ``modulated_deform_conv`` for the output
    gradient g (B,H,W,Co): ``(dx, doffset, dmask, dweight, dbias)``, all
    float32, as ``dcn_pallas_v3_bwd`` returns them.  Those not named in
    ``wrt`` come back as None (dbias = sum of g is always given).

    - dx is the gradient with respect to the rounded x, so it does not depend
      on ``transfer_dtype``; dweight, dmask and doffset are evaluated at the
      rounded x, as the TPU kernel dwmo3 evaluates them.
    - doffset is the floor-based, one-sided derivative of bilinear sampling
      (the reference CUDA op's convention), gated by |o| <= R through the
      clamp.  At integer offsets the TPU kernels' hat-window derivative is 0
      instead (ROADMAP C1).
    """
    leaves = {"x": x.to(transfer_dtype).float(), "offset": offset, "mask": mask,
              "weight": weight}
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(k in wrt) for k, v in leaves.items()}
        out = modulated_deform_conv(leaves["x"], leaves["offset"], leaves["mask"],
                                    leaves["weight"], max_offset=max_offset)
        grads = torch.autograd.grad(out, [leaves[k] for k in wrt], g)
    got = dict(zip(wrt, grads))
    return (got.get("x"), got.get("offset"), got.get("mask"), got.get("weight"),
            g.sum(dim=(0, 1, 2)))
