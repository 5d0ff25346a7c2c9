"""Where XLA rounds the JAX package's "shift" DCN under a bf16 x (ROADMAP
C14), read from its optimised HLO on the CPU, and a torch op that rounds at
those points.

``monoflex_tpu/ops/dcn.py::modulated_deform_conv_shift`` writes every
weight, product and running sum of a tap's (2R+1)^2 window in bf16, then
multiplies the window sum by the f32 mask.  XLA's optimised HLO rounds each
of them to bf16 (f32 arithmetic, then convert to bf16 and back) but one:
the last running sum of each tap (adding row ky + R), whose f32 add feeds
the mask product directly.  That point follows the op's structure, one per
tap.  ``shift_as_xla_rounds`` below is the port's op
(``monoflex_tpu_torch/ops/dcn.py::modulated_deform_conv_shift``, which
rounds that sum too) with that one sum kept in f32, and it is bit-equal to
the XLA op.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.ops.dcn import modulated_deform_conv_shift as jax_shift
from test_torch_bf16_shift import R, operands


def shift_as_xla_rounds(x, offset, mask, weight, bias, max_offset):
    """The clamped DCN with the XLA op's roundings: the 4 corners of the
    clamped point in the op's order, products and row sums in x's dtype,
    the sum of the two rows in x's dtype unless it is the tap's last
    running sum (row dy0 + 1 = ky + R), which stays f32."""
    B, H, W, C = x.shape
    Co = weight.shape[3]
    R = float(max_offset)
    x_rows = x.reshape(B * H * W, C)
    base = torch.arange(B).view(B, 1, 1) * (H * W)
    ys, xs = torch.arange(H).view(1, H, 1), torch.arange(W).view(1, 1, W)

    def hat(t):
        return (1.0 - t.abs()).clamp_min(0.0)

    out = 0
    for k in range(9):
        ky, kx = k // 3 - 1, k % 3 - 1
        oy = offset[..., 2 * k].clamp(-R, R)
        ox = offset[..., 2 * k + 1].clamp(-R, R)
        dy0, dx0 = torch.floor(oy) + ky, torch.floor(ox) + kx
        rows = []
        for dy in (dy0, dy0 + 1):
            wy = hat(oy + ky - dy)
            row = 0
            for dx in (dx0, dx0 + 1):
                w = (wy * hat(ox + kx - dx)).to(x.dtype)
                yi, xi = ys + dy.long(), xs + dx.long()
                inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
                idx = base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
                row = row + (x_rows.index_select(0, idx.reshape(-1)).view(B, H, W, C)
                             * (w * inside)[..., None])
            rows.append(row)
        s = rows[0].float() + rows[1].float()
        s = torch.where((dy0 + 1 == ky + R)[..., None], s, s.to(x.dtype).float())
        out = out + (s * mask[..., k:k + 1]).reshape(B * H * W, C) @ weight[k // 3, k % 3]
    return (out + bias).view(B, H, W, Co).to(x.dtype)


def window_sums(hlo: str):
    """(rounded, kept in f32) counts of the HLO's window sums: f32 adds of
    two values converted from bf16, by whether the sum is converted to bf16."""
    rounded = kept = 0
    for body in re.findall(r"^%\S+ \(.*?^}", hlo, re.S | re.M):
        defs, users = {}, {}
        for line in body.splitlines()[1:-1]:
            m = re.match(r"\s*(?:ROOT )?(%\S+) = (\S+) (\w+)\((.*?)\)", line)
            if m:
                name, ty, op, args = m.groups()
                defs[name] = (ty, op, re.findall(r"%[\w.\-]+", args))
                for a in defs[name][2]:
                    users.setdefault(a, []).append(name)

        def from_bf16(n):
            ty, op, args = defs.get(n, ("", "", []))
            return op == "convert" and bool(args) and defs.get(args[0], ("",))[0].startswith("bf16")

        for name, (ty, op, args) in defs.items():
            if op == "add" and ty.startswith("f32") and len(args) == 2 and all(map(from_bf16, args)):
                if any(defs[u][1] == "convert" and defs[u][0].startswith("bf16")
                       for u in users.get(name, [])):
                    rounded += 1
                else:
                    kept += 1
    return rounded, kept


def test_xla_keeps_one_window_sum_a_tap_in_f32():
    x, off, mask, w, b = operands()
    hlo = jax.jit(lambda *a: jax_shift(*a, max_offset=R)).lower(
        jnp.asarray(x).astype(jnp.bfloat16), off, mask, w, b).compile().as_text()
    # per tap: (2R+1) rows of 2R adds, then 2R adds over the rows
    sums = 9 * ((2 * R + 1) * 2 * R + 2 * R)
    assert window_sums(hlo) == (sums - 9, 9)


@pytest.mark.parametrize("seed", range(4))
def test_the_last_sum_in_f32_is_the_xla_op(seed):
    x, off, mask, w, b = operands(seed)
    want = jax.jit(lambda *a: jax_shift(*a, max_offset=R))(
        jnp.asarray(x).astype(jnp.bfloat16), off, mask, w, b)
    got = shift_as_xla_rounds(torch.from_numpy(x).bfloat16(),
                              *map(torch.from_numpy, (off, mask, w, b)), max_offset=R)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
