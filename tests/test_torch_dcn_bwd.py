"""The port's DCNv2 backward (the plain ``modulated_deform_conv_backward``, the
oracle of both backward kernels, and the autograd Function the model calls)
against the JAX package's backward kernels in interpret mode: dx against
``dcn_pallas_v5_bwd_dx`` (and dx3/dx4, which compute the same dx), dmask, dW
and doffset against ``dcn_pallas_v3_bwd_dwmo``.

Tolerances.  dx, dmask and doffset 1e-5 abs: O(1) values, float32 on both
sides, summation order only (the largest gap measured is about 4e-6).  dW
sums over every pixel (values up to about 30 here), so it is held to 1e-5 of
its largest element.  Offsets are pinned away from integers, where the Pallas
hat-window derivative and the floor-based derivative of bilinear sampling
part ways (ROADMAP C1; ``test_integer_offsets_take_the_one_sided_derivative``
pins that divergence).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monoflex_tpu.ops.dcn_pallas_v3 as DP3
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.models.backbone.dla import resolve_dcn_specs
from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import modulated_deform_conv, modulated_deform_conv_backward
from test_torch_dcn import interpret_mode, make_inputs  # noqa: F401 (fixture)

ATOL = 1e-5
DW_RTOL = 1e-5
TRANSFER = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, jnp.bfloat16)}


def with_grad_output(seed=0, **shape):
    x, off, mask, w, _ = make_inputs(seed=seed, **shape)
    g = np.random.RandomState(seed + 100).randn(*x.shape[:3], w.shape[-1]).astype(np.float32)
    return x, off, mask, w, g


def port_grads(arrays, R, transfer):
    """(plain backward, autograd Function) gradients, each (dx, doffset,
    dmask, dweight) as numpy."""
    x, off, mask, w, g = [torch.from_numpy(a) for a in arrays]
    plain = modulated_deform_conv_backward(x, off, mask, w, g, max_offset=R,
                                           transfer_dtype=transfer)[:4]
    leaves = [t.clone().requires_grad_() for t in (x, off, mask, w)]
    y = dcn_cuda.dcn_forward(*leaves, max_offset=R, transfer_dtype=transfer)
    func = torch.autograd.grad(y, leaves, g)
    return [[t.numpy() for t in grads] for grads in (plain, func)]


def assert_dw_close(got, want):
    assert np.abs(got - want).max() <= DW_RTOL * np.abs(want).max()


@pytest.mark.parametrize("R", [1, 2])
def test_dx_matches_dx5(interpret_mode, R):
    arrays = with_grad_output()
    ref = np.asarray(DP3.dcn_pallas_v5_bwd_dx(*map(jnp.asarray, arrays), max_offset=R))
    for transfer, _ in TRANSFER.values():
        for grads in port_grads(arrays, R, transfer):
            np.testing.assert_allclose(grads[0], ref, atol=ATOL)


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("transfer", ["f32", "bf16"])
def test_dmask_dweight_doffset_match_dwmo3(interpret_mode, R, transfer):
    arrays = with_grad_output(seed=1)
    torch_dtype, jax_dtype = TRANSFER[transfer]
    dmask, dw, doff = (np.asarray(a) for a in DP3.dcn_pallas_v3_bwd_dwmo(
        *map(jnp.asarray, arrays), max_offset=R, transfer_dtype=jax_dtype))
    for grads in port_grads(arrays, R, torch_dtype):
        np.testing.assert_allclose(grads[1], doff, atol=ATOL)
        np.testing.assert_allclose(grads[2], dmask, atol=ATOL)
        assert_dw_close(grads[3], dw)


@pytest.mark.parametrize("dx_fn", ["dcn_pallas_v3_bwd_dx", "dcn_pallas_v4_bwd_dx"])
def test_dx3_and_dx4_compute_the_same_dx(interpret_mode, dx_fn):
    """TPU.DCN_DX_KERNEL dx3/dx4/dx5 are one function, so one kernel serves
    all three."""
    arrays = with_grad_output(seed=2, B=1, H=13, W=20, C=8, Co=16)
    ref = np.asarray(getattr(DP3, dx_fn)(*map(jnp.asarray, arrays), max_offset=2))
    plain, _ = port_grads(arrays, 2, torch.float32)
    np.testing.assert_allclose(plain[0], ref, atol=ATOL)


def test_bf16_transfer_leaves_dx_in_float32():
    """P2: the transfer rounding of x is straight-through, so dx under bf16
    transfer equals dx under f32 transfer bit for bit (autograd of a bare
    ``x.to(bf16).float()`` would round dx itself to bf16)."""
    x, off, mask, w, g = [torch.from_numpy(a) for a in with_grad_output(seed=3)]
    dxs = []
    for transfer in (torch.float32, torch.bfloat16):
        leaf = x.clone().requires_grad_()
        y = modulated_deform_conv(leaf, off, mask, w, max_offset=2, transfer_dtype=transfer)
        dxs.append(torch.autograd.grad(y, leaf, g)[0])
    assert torch.equal(dxs[0], dxs[1])
    assert not torch.equal(dxs[1], dxs[1].bfloat16().float())


def test_integer_offsets_take_the_one_sided_derivative(interpret_mode):
    """C1: at integer offsets the port's doffset is the one-sided derivative
    of bilinear sampling (towards the next row or column), which a forward
    difference reproduces exactly, since the sample is linear within a cell;
    the Pallas hat-window derivative is 0 there."""
    rng = np.random.RandomState(4)
    x, _, mask, w, g = with_grad_output(seed=4, B=1, H=6, W=7, C=3, Co=2)
    off = rng.randint(-1, 2, size=(1, 6, 7, 18)).astype(np.float32)   # inside +-R
    R = 2
    _, _, doff = DP3.dcn_pallas_v3_bwd_dwmo(*map(jnp.asarray, (x, off, mask, w, g)),
                                            max_offset=R)
    assert np.abs(np.asarray(doff)).max() == 0.0

    t = {k: torch.from_numpy(a) for k, a in zip("xomwg", (x, off, mask, w, g))}
    got = modulated_deform_conv_backward(t["x"], t["o"], t["m"], t["w"], t["g"],
                                         max_offset=R)[1]
    assert got.abs().max().item() > 0.1

    def loss(o):
        return float((modulated_deform_conv(t["x"], o, t["m"], t["w"], max_offset=R)
                      * t["g"]).double().sum())

    h = 0.25
    base = loss(t["o"])
    for idx in np.ndindex(*off.shape):
        bumped = t["o"].clone()
        bumped[idx] += h
        assert abs((loss(bumped) - base) / h - got[idx].item()) <= 1e-4, idx


@pytest.mark.parametrize("name", ["dx3", "dx4", "dx5", "dx9"])
def test_dx_kernel_names_resolve_or_raise(name):
    """Every TPU.DCN_DX_KERNEL the JAX package takes builds (one kernel
    serves all three); any other name raises at build time."""
    cfg = get_cfg_defaults()
    cfg.TPU.DCN_DX_KERNEL = name
    if name == "dx9":
        with pytest.raises(ValueError, match="DCN_DX_KERNEL"):
            resolve_dcn_specs(cfg)
    else:
        assert len(resolve_dcn_specs(cfg)) == 4
