"""Modulated deformable 3x3 convolution (DCNv2), plain PyTorch.

The CPU path of the DCN and the oracle of the Hopper kernels
(``ops/dcn_cuda.py``): the forward, and its backward as the contract of
``monoflex_tpu/ops/dcn_pallas_v3.py::dcn_pallas_v3_bwd``.  Same contract as the JAX package's clamped DCN
(``monoflex_tpu/ops/dcn.py::modulated_deform_conv_shift`` and the Pallas
``dcn_pallas_v3``): each learned offset is clamped to [-R, R], the input is
sampled bilinearly at the 4 corners with zero padding, modulated by the mask
and contracted over the 9 taps x C channels.  The TPU kernels' (2R+1)^2 hat
window is exactly this bilinear sample at the clamped point.

Layouts follow the JAX op: x (B,H,W,C) NHWC, float32 or bfloat16 (a bf16
model's activation; its values are exact in f32, so the op reads them
without rounding); offset (B,H,W,18) interleaved (dy_k, dx_k) for taps k =
3*(ky+1) + (kx+1); mask (B,H,W,9) post-sigmoid; weight (3,3,C,Co).  Returns
(B,H,W,Co) float32.

``max_offset=None`` is the unbounded op, the port of the JAX package's
``modulated_deform_conv``/``bilinear_gather`` (the "gather" impl, an XLA op
there, not a Pallas kernel): no clamp, so a sample may lie any distance off
the map, and a corner outside the map contributes 0; the arithmetic is f32
and the output takes x's dtype, as the JAX op returns ``out.astype(x.dtype)``.
Its backward is autograd's, the floor-based derivative JAX's autodiff of the
gather gives.

``modulated_deform_conv_shift`` is the port of the JAX package's XLA clamped
op of the same name (the "shift" impl): the same function, with that op's
roundings under a bf16 x, where it weighs and sums each tap's window in bf16.

Two bf16 modes, as the TPU kernels have them:

- ``transfer_dtype=bfloat16`` (pallas3b): x is rounded once, then the math
  is float32;
- ``compute_dtype=bfloat16`` (the v1/v2 kernels' ``compute_dtype``,
  ``monoflex_tpu/ops/dcn_pallas.py``, ``dcn_pallas_v2.py``,
  ``dcn_pallas_bwd.py``): x, W and (in the backward) g are rounded to bf16,
  so is each bilinear corner weight times the mask, and so is each sampled
  value before its product with W; the products accumulate in float32.  The
  TPU's order of summation inside its (2R+1)^2 window is not reproduced.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

# (dy, dx) of the 4 bilinear corners
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))
# the dtypes of the window math, and those x may come in
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def round_to(t: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """t rounded to ``dtype`` and back, straight-through for autograd: t +
    (round(t) - t) is exactly round(t), since the difference of two floats
    within a factor of 2 of each other is exact."""
    return t + (t.to(dtype).float() - t).detach()


def check_compute_dtype(compute_dtype: torch.dtype) -> bool:
    """True for bf16 window math; raises on a dtype that is neither."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
    return compute_dtype == torch.bfloat16


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


def bilinear_columns(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor, scale,
                     round_weights: bool = False) -> torch.Tensor:
    """(B,H,W,9,C): x (B,H,W,C) sampled bilinearly at (py, px), each
    (B,H,W,9), with zero padding outside the map; each corner's weight is
    multiplied by ``scale`` (the mask, or 1) and, with ``round_weights``,
    rounded to bf16."""
    B, H, W, C = x.shape
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ly = py - y0
    lx = px - x0
    batch_base = torch.arange(B, device=x.device).view(B, 1, 1, 1) * (H * W)

    x_rows = x.reshape(B * H * W, C)
    cols = None
    for dy, dx in _CORNERS:
        yi = y0 + dy
        xi = x0 + dx
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        wgt = (ly if dy else 1.0 - ly) * (lx if dx else 1.0 - lx) * inside * scale
        if round_weights:
            wgt = round_to(wgt)
        # a NaN position (a diverged offset) samples row 0 with a NaN weight
        idx = (batch_base + yi.nan_to_num(0.0).clamp(0, H - 1).long() * W
               + xi.nan_to_num(0.0).clamp(0, W - 1).long())
        term = x_rows.index_select(0, idx.reshape(-1)).view(B, H, W, 9, C) * wgt[..., None]
        cols = term if cols is None else cols + term
    return cols


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                          max_offset: Optional[float],
                          transfer_dtype: torch.dtype = torch.float32,
                          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """DCNv2 forward with offsets clamped to +-max_offset, or unclamped
    under ``max_offset=None`` (module docstring; output in x's dtype then).

    transfer_dtype: x is rounded to this dtype before sampling (bf16 mirrors
    the TPU kernel's bf16-shipped x); the arithmetic is float32 either way, so
    the result equals the float32 op on the rounded x.  compute_dtype=bf16
    is the bf16 window math (module docstring).  Every rounding is
    straight-through for autograd: dx is the float32 gradient with respect to
    the rounded x, as the TPU backward returns it, not a bf16-rounded one.
    """
    check_dcn_inputs(x, offset, mask, weight, bias, x_dtypes=COMPUTE_DTYPES)
    bf16_math = check_compute_dtype(compute_dtype)
    out_dtype = x.dtype if max_offset is None else torch.float32
    B, H, W, C = x.shape
    Co = weight.shape[3]
    x = x.float()
    if transfer_dtype != torch.float32:
        x = round_to(x, transfer_dtype)
    if bf16_math:
        x, weight = round_to(x), round_to(weight)
    dev = x.device
    oy, ox = offset[..., 0::2], offset[..., 1::2]
    if max_offset is not None:
        R = float(max_offset)
        oy, ox = oy.clamp(-R, R), ox.clamp(-R, R)

    k = torch.arange(9, device=dev)
    ky = (k // 3 - 1).float()
    kx = (k % 3 - 1).float()
    py = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1, 1) + ky + oy  # (B,H,W,9)
    px = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W, 1) + kx + ox
    cols = bilinear_columns(x, py, px, mask, round_weights=bf16_math)
    if bf16_math:
        cols = round_to(cols)
    out = (cols.reshape(B * H * W, 9 * C) @ weight.reshape(9 * C, Co)).view(B, H, W, Co)
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def modulated_deform_conv_shift(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                                max_offset: int) -> torch.Tensor:
    """The clamped DCN as the JAX package's ``modulated_deform_conv_shift``
    computes it, output in x's dtype.  That op sums, for each tap, the
    (2R+1)^2 shifted copies of x weighted by hat(oy + ky - dy) * hat(ox + kx
    - dx): the weight cast to x's dtype, each product and each running sum in
    x's dtype.  Only the 4 corners of the clamped point have a nonzero
    weight and adding a zero is exact, so the same roundings come from the 4
    corners in the op's order (along x, then the two rows), with each weight
    formed by the op's own f32 arithmetic.  The window sum times the mask is
    f32 and so is its contraction with W.  Under a float32 x this is
    ``modulated_deform_conv`` up to the order of the f32 sums."""
    check_dcn_inputs(x, offset, mask, weight, bias, x_dtypes=COMPUTE_DTYPES)
    B, H, W, C = x.shape
    Co = weight.shape[3]
    R = float(max_offset)
    dev = x.device
    x_rows = x.reshape(B * H * W, C)
    batch_base = torch.arange(B, device=dev).view(B, 1, 1) * (H * W)
    ys = torch.arange(H, device=dev).view(1, H, 1)
    xs = torch.arange(W, device=dev).view(1, 1, W)

    def hat(t):
        return (1.0 - t.abs()).clamp_min(0.0)

    out = None
    for k in range(9):
        ky, kx = k // 3 - 1, k % 3 - 1
        oy = offset[..., 2 * k].clamp(-R, R)
        ox = offset[..., 2 * k + 1].clamp(-R, R)
        # the window's rows dy and columns dx that the sample falls between
        dy0 = torch.floor(oy).detach() + ky
        dx0 = torch.floor(ox).detach() + kx
        s = None
        for dy in (dy0, dy0 + 1):
            wy = hat(oy + ky - dy)
            row = None
            for dx in (dx0, dx0 + 1):
                w = (wy * hat(ox + kx - dx)).to(x.dtype)
                yi, xi = ys + dy.long(), xs + dx.long()
                inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
                idx = batch_base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
                term = (x_rows.index_select(0, idx.reshape(-1)).view(B, H, W, C)
                        * (w * inside)[..., None])
                row = term if row is None else row + term
            s = row if s is None else s + row
        part = (s * mask[..., k:k + 1]).reshape(B * H * W, C) @ weight[k // 3, k % 3]
        out = part if out is None else out + part
    if bias is not None:
        out = out + bias
    return out.view(B, H, W, Co).to(x.dtype)


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
    check_dcn_inputs(x, offset, mask, weight, None, x_dtypes=COMPUTE_DTYPES)
    check_epilogue(x, weight, scale, shift)
    y = modulated_deform_conv(x, offset, mask, weight, None, max_offset=max_offset,
                              transfer_dtype=transfer_dtype)
    return torch.relu(y * scale + shift)


_WRT = ("x", "offset", "mask", "weight")


def modulated_deform_conv_backward(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                   weight: torch.Tensor, g: torch.Tensor, *, max_offset: int,
                                   transfer_dtype: torch.dtype = torch.float32,
                                   compute_dtype: torch.dtype = torch.float32,
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
    - compute_dtype=bf16: the gradients of the bf16-math forward with g
      rounded to bf16, each rounding straight-through.  So u = W_b g_b is
      float32 from rounded operands, dx scatters u with the rounded corner
      weights, dW sums the rounded samples times g_b, and dmask and doffset
      take the unrounded float32 samples of the rounded x.
    """
    bf16_math = check_compute_dtype(compute_dtype)
    leaves = {"x": x.to(transfer_dtype).float(), "offset": offset, "mask": mask,
              "weight": weight}
    g_in = g.to(torch.bfloat16).float() if bf16_math else g
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(k in wrt) for k, v in leaves.items()}
        out = modulated_deform_conv(leaves["x"], leaves["offset"], leaves["mask"],
                                    leaves["weight"], max_offset=max_offset,
                                    compute_dtype=compute_dtype)
        grads = torch.autograd.grad(out, [leaves[k] for k in wrt], g_in)
    got = dict(zip(wrt, grads))
    return (got.get("x"), got.get("offset"), got.get("mask"), got.get("weight"),
            g.sum(dim=(0, 1, 2)))


def _shifted(t: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """t (B,H,W,C) moved by (sy, sx) along H and W: out[:, y, x] = t[:, y - sy,
    x - sx], zero where that lies off the map."""
    _, H, W, _ = t.shape
    out = torch.zeros_like(t)
    if abs(sy) < H and abs(sx) < W:
        out[:, max(sy, 0):H + min(sy, 0), max(sx, 0):W + min(sx, 0)] = \
            t[:, max(-sy, 0):H - max(sy, 0), max(-sx, 0):W - max(sx, 0)]
    return out


def modulated_deform_conv_dx_mirrored(offset: torch.Tensor, mask: torch.Tensor,
                                      weight: torch.Tensor, g: torch.Tensor, *,
                                      max_offset: int,
                                      compute_dtype: torch.dtype = torch.float32
                                      ) -> torch.Tensor:
    """dx of ``modulated_deform_conv`` for the output gradient g (B,H,W,Co), by
    the algorithm of ``csrc/dcn_bwd_dx.cu`` (and of the TPU's dx5): per tap
    k, the mirrored gather

        z_k[q] = sum_{e,f in [-R',R']} wt_k(p -> q) g(p),  p = q - (ky + e, kx + f),

    with wt_k(p -> q) the bilinear weight times the mask of the corner of p's
    tap-k sample that lands on q (0 where none does; R' = ceil(R)), summed in
    (e, f) order, then dx = sum_k z_k W_k^T.  The corner weights are formed at
    the source as the forward forms them.  Under ``compute_dtype=bfloat16`` g,
    W and each corner weight are rounded to bf16 and the sums are float32.
    The same function as ``modulated_deform_conv_backward(..., wrt=("x",))``,
    reassociated; the tests hold the two together.  Not on any model path."""
    bf16_math = check_compute_dtype(compute_dtype)
    B, H, W, Co = g.shape
    C = weight.shape[2]
    R = float(max_offset)
    reach = math.ceil(R)
    dev = g.device
    if bf16_math:
        g, weight = g.to(torch.bfloat16).float(), weight.to(torch.bfloat16).float()
    k = torch.arange(9, device=dev)
    # the tap's integer point, and the floor and fractional part of the sample
    # point, at each source pixel, as the forward computes them
    ty = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1, 1) + (k // 3 - 1).float()
    tx = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W, 1) + (k % 3 - 1).float()
    py = ty + offset[..., 0::2].clamp(-R, R)                         # (B,H,W,9)
    px = tx + offset[..., 1::2].clamp(-R, R)
    ly, lx = py - torch.floor(py), px - torch.floor(px)
    dy0, dx0 = torch.floor(py) - ty, torch.floor(px) - tx            # in [-R', R']
    dx = torch.zeros(B, H, W, C, device=dev, dtype=torch.float32)
    for tap in range(9):
        ky, kx = tap // 3 - 1, tap % 3 - 1
        z = torch.zeros(B, H, W, Co, device=dev, dtype=torch.float32)
        for e in range(-reach, reach + 1):
            dy = e - dy0[..., tap]
            wy = torch.where(dy == 1, ly[..., tap], 1.0 - ly[..., tap])
            for f in range(-reach, reach + 1):
                dxc = f - dx0[..., tap]
                wx = torch.where(dxc == 1, lx[..., tap], 1.0 - lx[..., tap])
                wt = wy * wx * mask[..., tap]
                if bf16_math:
                    wt = wt.to(torch.bfloat16).float()
                hit = ((dy == 0) | (dy == 1)) & ((dxc == 0) | (dxc == 1))
                wt = torch.where(hit, wt, torch.zeros_like(wt))
                z = z + _shifted(wt[..., None] * g, ky + e, kx + f)
        dx = dx + z @ weight[ky + 1, kx + 1].T
    return dx


def modulated_deform_conv_dx_wide(offset: torch.Tensor, mask: torch.Tensor,
                                  weight: torch.Tensor, g: torch.Tensor, *,
                                  max_offset: int,
                                  compute_dtype: torch.dtype = torch.float32
                                  ) -> torch.Tensor:
    """dx of ``modulated_deform_conv`` for the output gradient g (B,H,W,Co), by
    the algorithm of ``csrc/dcn_bwd_dx.cu``'s wide path (ceil(R) > 11): the
    contraction first, u_k = g W_k^T (B,H,W,C) for each tap k, then the
    mirrored gather of u,

        dx[q] = sum_k sum_{e,f in [-R',R']} wt_k(p -> q) u_k(p),  p = q - (ky + e, kx + f),

    summed in (k, e, f) order, with the corner weights formed at the source
    as the forward forms them (0 where no corner of p's tap-k sample lands on
    q).  Under ``compute_dtype=bfloat16`` g, W and each corner weight are
    rounded to bf16 and the sums are float32.  The same function as
    ``modulated_deform_conv_backward(..., wrt=("x",))``; the tests hold the
    two together.  Not on any model path."""
    bf16_math = check_compute_dtype(compute_dtype)
    B, H, W, Co = g.shape
    C = weight.shape[2]
    R = float(max_offset)
    reach = math.ceil(R)
    dev = g.device
    if bf16_math:
        g, weight = g.to(torch.bfloat16).float(), weight.to(torch.bfloat16).float()
    k = torch.arange(9, device=dev)
    ty = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1, 1) + (k // 3 - 1).float()
    tx = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W, 1) + (k % 3 - 1).float()
    py = ty + offset[..., 0::2].clamp(-R, R)                         # (B,H,W,9)
    px = tx + offset[..., 1::2].clamp(-R, R)
    ly, lx = py - torch.floor(py), px - torch.floor(px)
    dy0, dx0 = torch.floor(py) - ty, torch.floor(px) - tx            # in [-R', R']
    dx = torch.zeros(B, H, W, C, device=dev, dtype=torch.float32)
    for tap in range(9):
        ky, kx = tap // 3 - 1, tap % 3 - 1
        u = g @ weight[ky + 1, kx + 1].T                              # (B,H,W,C)
        for e in range(-reach, reach + 1):
            dy = e - dy0[..., tap]
            wy = torch.where(dy == 1, ly[..., tap], 1.0 - ly[..., tap])
            for f in range(-reach, reach + 1):
                dxc = f - dx0[..., tap]
                wx = torch.where(dxc == 1, lx[..., tap], 1.0 - lx[..., tap])
                wt = wy * wx * mask[..., tap]
                if bf16_math:
                    wt = wt.to(torch.bfloat16).float()
                hit = ((dy == 0) | (dy == 1)) & ((dxc == 0) | (dxc == 1))
                wt = torch.where(hit, wt, torch.zeros_like(wt))
                dx = dx + _shifted(wt[..., None] * u, ky + e, kx + f)
    return dx
