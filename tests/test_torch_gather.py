"""The unbounded DCN ("gather", ``max_offset=None``): the port's plain op
against the JAX package's ``modulated_deform_conv`` (its XLA gather), and the
model on it against the JAX model on it, plus the routing of mixed per-stage
impls.

- The op, f32: forward and the five gradients (x, offset, mask, weight,
  bias) with offsets up to 12 pixels on an 8x16 map, so samples land far
  outside it: 1e-5 abs (f32 both sides, summation order only).
- The op on a bf16 x: the output is bf16 (the JAX op's ``astype(x.dtype)``)
  within one bf16 ulp of JAX's; dx is bf16, within two bf16 ulps of its
  largest element (JAX scatters each corner's bf16-rounded share and sums in
  bf16, the port sums in f32 and rounds once).
- The narrow model of ``test_torch_slice.py`` with every stage on "gather",
  against the JAX model with dcn_impl "gather", f32: head maps 1e-4 abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.models.backbone.dla import DLASeg as JaxDLASeg
from monoflex_tpu.models.detector import MonoFlex as JaxMonoFlex
from monoflex_tpu.models.heads.predictor import build_predictor as jax_build_predictor
from monoflex_tpu.ops.dcn import modulated_deform_conv as jax_gather
from monoflex_tpu_torch.data.synthetic import make_inference_batch
from monoflex_tpu_torch.models.backbone import dla
from monoflex_tpu_torch.ops.dcn import modulated_deform_conv
from test_torch_slice import (ATOL, B, H, NARROW_CHANNELS, W, narrow_cfg, perturbed_port_model,
                              port_narrow_model, to_flax)

OP_ATOL = 1e-5
BF16_ULP = 2.0 ** -8


def op_inputs(seed=0, B=2, H=8, W=16, C=24, Co=40):
    rs = np.random.RandomState(seed)
    return dict(x=rs.randn(B, H, W, C).astype(np.float32),
                offset=(rs.randn(B, H, W, 18) * 6).astype(np.float32),
                mask=rs.rand(B, H, W, 9).astype(np.float32),
                weight=(rs.randn(3, 3, C, Co) * 0.1).astype(np.float32),
                bias=rs.randn(Co).astype(np.float32),
                g=rs.randn(B, H, W, Co).astype(np.float32))


def jax_op(inp, x_dtype):
    def f(x, offset, mask, weight, bias):
        y = jax_gather(x, offset, mask, weight, bias)
        return (y.astype(jnp.float32) * inp["g"]).sum(), y

    args = [jnp.asarray(inp[k]) for k in ("x", "offset", "mask", "weight", "bias")]
    args[0] = args[0].astype(x_dtype)
    (_, y), grads = jax.value_and_grad(f, argnums=range(5), has_aux=True)(*args)
    return y, grads


def port_op(inp, x_dtype):
    leaves = [torch.from_numpy(inp[k]).requires_grad_()
              for k in ("offset", "mask", "weight", "bias")]
    x = torch.from_numpy(inp["x"]).to(x_dtype).requires_grad_()
    y = modulated_deform_conv(x, *leaves[:3], leaves[3], max_offset=None)
    (y.float() * torch.from_numpy(inp["g"])).sum().backward()
    return y, [x.grad] + [t.grad for t in leaves]


def test_unbounded_op_matches_jax_gather():
    inp = op_inputs()
    assert (np.abs(inp["offset"]) > 8).any()     # off the 8-row map
    y, grads = jax_op(inp, jnp.float32)
    ty, tgrads = port_op(inp, torch.float32)
    assert ty.dtype == torch.float32
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), atol=OP_ATOL)
    for name, got, want in zip(("x", "offset", "mask", "weight", "bias"), tgrads, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL * 10, rtol=1e-5,
                                   err_msg=name)


def test_unbounded_op_keeps_a_bf16_x_in_bf16():
    inp = op_inputs(seed=1)
    y, grads = jax_op(inp, jnp.bfloat16)
    ty, tgrads = port_op(inp, torch.bfloat16)
    assert ty.dtype == torch.bfloat16 and y.dtype == jnp.bfloat16
    got, want = ty.detach().float().numpy(), np.asarray(y.astype(jnp.float32))
    big = np.abs(want).max()
    assert (np.abs(got - want) <= BF16_ULP * np.maximum(np.abs(want), 1e-2 * big)).all()
    assert tgrads[0].dtype == torch.bfloat16
    gx, want_gx = tgrads[0].float().numpy(), np.asarray(grads[0].astype(jnp.float32))
    assert np.abs(gx - want_gx).max() <= 2 * BF16_ULP * np.abs(want_gx).max()


def test_the_clamp_is_off():
    """Within R the unbounded op equals the clamped one; past R it does not."""
    inp = op_inputs(seed=2)
    args = [torch.from_numpy(inp[k]) for k in ("x", "offset", "mask", "weight", "bias")]
    small = [args[0], args[1].clamp(-1.9, 1.9), *args[2:]]
    np.testing.assert_allclose(modulated_deform_conv(*small, max_offset=None).numpy(),
                               modulated_deform_conv(*small, max_offset=2).numpy(), atol=1e-6)
    far = (modulated_deform_conv(*args, max_offset=None)
           - modulated_deform_conv(*args, max_offset=2)).abs().max()
    assert far > 0.1


def test_nan_offsets_give_nan_not_an_error():
    """A diverged offset makes its samples NaN, as the JAX gather's do; the
    step's non-finite guard then skips the update."""
    inp = op_inputs(seed=3)
    args = [torch.from_numpy(inp[k]) for k in ("x", "offset", "mask", "weight", "bias")]
    args[1][0, 2, 3, 4] = float("nan")
    for max_offset in (None, 2):
        y = modulated_deform_conv(*args, max_offset=max_offset)
        assert torch.isnan(y[0, 2, 3]).all()
        assert torch.isfinite(y[1]).all()


@pytest.fixture(scope="module")
def gather_models():
    cfg = narrow_cfg("gather")
    model = perturbed_port_model(cfg)
    specs = dla.resolve_dcn_specs(cfg)
    assert all(s.max_offset is None and not s.use_kernel and s.impl == "gather" for s in specs)
    params, stats = to_flax(model, cfg)
    batch = make_inference_batch(B, H, W)
    jmodel = JaxMonoFlex(backbone=JaxDLASeg(channels=NARROW_CHANNELS, dcn_impl="gather"),
                         predictor=jax_build_predictor(cfg))
    ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        {"params": params, "batch_stats": stats},
        *(jnp.asarray(batch[k]) for k in ("image", "edge_indices", "edge_len")))
    with torch.no_grad():
        out = model(*(torch.from_numpy(batch[k]) for k in ("image", "edge_indices", "edge_len")))
    return cfg, model, batch, ref, out


def test_gather_model_matches_jax(gather_models):
    _, _, _, ref, out = gather_models
    np.testing.assert_allclose(out["cls"].permute(0, 2, 3, 1).numpy(), np.asarray(ref["cls"]),
                               atol=ATOL)
    for got, want in zip(out["reg"], ref["reg"]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=ATOL)


def test_gather_model_differs_from_the_clamped_model(gather_models):
    """The perturbed offsets pass the per-stage clamp: the gather model is
    not the clamped one."""
    cfg, model, batch, _, out = gather_models
    clamped = port_narrow_model(narrow_cfg("pallas3"))
    clamped.load_state_dict(model.state_dict())
    with torch.no_grad():
        out2 = clamped(*(torch.from_numpy(batch[k])
                         for k in ("image", "edge_indices", "edge_len")))
    assert (out["reg"][1] - out2["reg"][1]).abs().max() > 1e-3


def test_mixed_stages_run_the_kernel_on_the_kernel_stages(monkeypatch):
    """("gather", "pallas3b", "pallas3b", "pallas3b"): ida_0's two DCNs on
    the unbounded op, the other 14 through the kernel wrapper."""
    cfg = narrow_cfg("")
    cfg.TPU.DCN_IMPL_PER_STAGE = ("gather", "pallas3b", "pallas3b", "pallas3b")
    specs = dla.resolve_dcn_specs(cfg)
    assert specs[0].max_offset is None and not specs[0].use_kernel
    assert all(s.use_kernel and s.max_offset == r for s, r in zip(specs[1:], (1, 1, 1)))
    calls = {"kernel": 0, "plain": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(dla, "dcn_forward", counting("kernel", dla.dcn_forward))
    monkeypatch.setattr(dla, "modulated_deform_conv",
                        counting("plain", dla.modulated_deform_conv))
    model = perturbed_port_model(cfg)
    batch = make_inference_batch(1, H, W)
    with torch.no_grad():
        model(*(torch.from_numpy(batch[k]) for k in ("image", "edge_indices", "edge_len")))
    assert calls == {"kernel": 14, "plain": 2}
