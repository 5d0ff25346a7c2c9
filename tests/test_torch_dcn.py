"""The port's plain DCNv2 op (the CPU path and the Hopper kernel's oracle)
against the JAX package's clamped DCN: the v3 Pallas kernel in interpret mode
and the XLA shift op, on the same numpy inputs.

Tolerance 1e-4 abs on O(1) outputs: both sides compute in float32 and differ
only in summation order.  Offsets are pinned away from integers, where the
hat window and the floor of bilinear sampling meet at a kink.
"""

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monoflex_tpu.ops.dcn_pallas_v3 as DP3
from monoflex_tpu.ops.dcn import modulated_deform_conv_shift
from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import modulated_deform_conv

ATOL = 1e-4


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(DP3.pl, "pallas_call", patched)


def make_inputs(seed=0, B=1, H=16, W=32, C=8, Co=8):
    rng = np.random.RandomState(seed)
    off = (rng.randn(B, H, W, 18) * 1.5).astype(np.float32)
    near_int = np.abs(off - np.round(off)) < 0.05
    off[near_int] += 0.1
    return (rng.randn(B, H, W, C).astype(np.float32), off,
            rng.rand(B, H, W, 9).astype(np.float32),
            (rng.randn(3, 3, C, Co) * 0.1).astype(np.float32),
            rng.randn(Co).astype(np.float32))


def run_port(arrays, R, transfer):
    t = [torch.from_numpy(a) for a in arrays]
    return modulated_deform_conv(*t, max_offset=R, transfer_dtype=transfer).numpy()


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("transfer", ["f32", "bf16"])
def test_plain_dcn_matches_pallas_v3(interpret_mode, R, transfer):
    arrays = make_inputs()
    out = run_port(arrays, R, {"f32": torch.float32, "bf16": torch.bfloat16}[transfer])
    ref = DP3.dcn_pallas_v3(*map(jnp.asarray, arrays), max_offset=R,
                            transfer_dtype={"f32": None, "bf16": jnp.bfloat16}[transfer])
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("transfer", ["f32", "bf16"])
def test_plain_dcn_matches_shift_op(R, transfer):
    """The XLA shift op on the (optionally bf16-rounded) x, with larger C and
    a ragged map, so both corners of the frame and the clamp are hit."""
    x, off, mask, w, b = make_inputs(seed=1, B=2, H=13, W=20, C=24, Co=16)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[transfer]
    out = run_port((x, off, mask, w, b), R, dtype)
    xq = jnp.asarray(x)
    if transfer == "bf16":
        xq = xq.astype(jnp.bfloat16).astype(jnp.float32)
    ref = modulated_deform_conv_shift(xq, jnp.asarray(off), jnp.asarray(mask),
                                      jnp.asarray(w), jnp.asarray(b), max_offset=R)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


def test_bf16_transfer_rounds_x():
    arrays = make_inputs(seed=2)
    diff = np.abs(run_port(arrays, 2, torch.bfloat16) - run_port(arrays, 2, torch.float32))
    assert diff.max() > ATOL


def test_zero_offsets_unit_mask_is_a_conv():
    """With no deformation and mask 1 the op is a 3x3 conv: pins the tap
    order (k = 3*(ky+1) + (kx+1)) and the weight layout (3,3,C,Co)."""
    x, _, _, w, b = make_inputs(seed=3, B=2, C=5, Co=7)
    t = torch.from_numpy
    out = modulated_deform_conv(t(x), torch.zeros(2, 16, 32, 18), torch.ones(2, 16, 32, 9),
                                t(w), t(b), max_offset=2)
    ref = torch.nn.functional.conv2d(t(x).permute(0, 3, 1, 2), t(w).permute(3, 2, 0, 1),
                                     t(b), padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)


def test_wrapper_on_cpu_runs_the_plain_op():
    t = [torch.from_numpy(a) for a in make_inputs(seed=4)]
    before = dcn_cuda.dcn_forward.launches
    out = dcn_cuda.dcn_forward(*t, max_offset=2, transfer_dtype=torch.bfloat16)
    ref = modulated_deform_conv(*t, max_offset=2, transfer_dtype=torch.bfloat16)
    assert torch.equal(out, ref)
    assert dcn_cuda.dcn_forward.launches == before


@pytest.mark.parametrize("bad", ["x_dtype", "offset_shape", "mask_shape", "weight_cin",
                                 "bias_shape"])
def test_wrapper_rejects_malformed_operands(bad):
    x, off, mask, w, b = [torch.from_numpy(a) for a in make_inputs(seed=5)]
    if bad == "x_dtype":
        x = x.double()
    elif bad == "offset_shape":
        off = off[..., :9]
    elif bad == "mask_shape":
        mask = mask[:, :8]
    elif bad == "weight_cin":
        w = w[:, :, :4]
    else:
        b = b[:3]
    with pytest.raises(ValueError):
        dcn_cuda.dcn_forward(x, off, mask, w, b, max_offset=2)
