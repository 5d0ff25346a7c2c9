"""The "shift" impl (the JAX package's XLA clamped DCN,
``monoflex_tpu/ops/dcn.py::modulated_deform_conv_shift``) in the port,
``ops/dcn.py::modulated_deform_conv_shift``, against the JAX op and in the
narrow model of ``test_torch_bf16.py`` against the JAX model, under a bf16
and a float32 model.

Under a bf16 x the JAX op weighs and sums each tap's window in bf16 and
returns bf16; the port rounds at the same points.  Tolerances:
- the op, bf16 x: 2^-7 of the largest output, abs (measured 2^-9 of it),
  and at most 20% of the outputs not bit-equal (measured 7.2%; the same op
  with its window summed in f32 measured 57%).  XLA's fusion of the window
  sums does not round every one of them as the op is written, so some
  sums part by a bf16 ulp, which the f32 contraction carries; float32 x:
  1e-5 abs (measured 3e-7).
- the op's gradients, float32 x, offsets away from integers: 1e-5 relative
  L2 (measured 1.3e-7).
- the model's head maps, eval mode: bf16 ``MAP_ATOL`` of
  ``test_torch_bf16.py``, 5e-3 abs (measured 5.2e-4; summing the window in
  f32, as the plain clamped op does, measured 7.1e-3); float32 1e-4 abs
  (measured 1.9e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.models.backbone.dla import DLASeg as JaxDLASeg
from monoflex_tpu.models.detector import MonoFlex as JaxMonoFlex
from monoflex_tpu.models.heads.predictor import build_predictor as jax_build_predictor
from monoflex_tpu.ops.dcn import modulated_deform_conv_shift as jax_shift
from monoflex_tpu_torch.data.synthetic import make_inference_batch
from monoflex_tpu_torch.models.layers import set_compute_dtype
from monoflex_tpu_torch.ops.dcn import modulated_deform_conv, modulated_deform_conv_shift
from test_torch_bf16 import MAP_ATOL, bf16_cfg, bf16_port_model
from test_torch_slice import ATOL, B, H, NARROW_CHANNELS, STAGE_R, W, to_flax

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}
R = 2


def operands(seed=0, B=2, H=9, W=11, C=8, Co=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, C)).astype(np.float32),
            (rng.standard_normal((B, H, W, 18)) * 1.5).astype(np.float32),
            rng.uniform(size=(B, H, W, 9)).astype(np.float32),
            (rng.standard_normal((3, 3, C, Co)) * 0.2).astype(np.float32),
            rng.standard_normal(Co).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_shift_op_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    x, off, mask, w, b = operands()
    got = modulated_deform_conv_shift(torch.from_numpy(x).to(tdt), *map(torch.from_numpy,
                                      (off, mask, w, b)), max_offset=R)
    want = jax.jit(lambda *a: jax_shift(*a, max_offset=R))(
        jnp.asarray(x).astype(jdt), off, mask, w, b)
    assert got.dtype == tdt and want.dtype == jdt
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    if tdt == torch.bfloat16:
        np.testing.assert_allclose(got, want, atol=2.0 ** -7 * np.abs(want).max(), rtol=0)
        assert (got != want).mean() <= 0.2
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        # under f32 the same function as the plain clamped op
        plain = modulated_deform_conv(*map(torch.from_numpy, (x, off, mask, w, b)),
                                      max_offset=R)
        np.testing.assert_allclose(got, plain.numpy(), atol=1e-5, rtol=0)


def test_shift_op_gradients_match_jax():
    x, off, mask, w, _ = operands(seed=1)
    g = np.random.default_rng(2).standard_normal((*x.shape[:3], w.shape[3])).astype(np.float32)

    def jax_loss(*a):
        return (jax_shift(*a, None, max_offset=R) * g).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(x, off, mask, w)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, off, mask, w)]
    (modulated_deform_conv_shift(*leaves, max_offset=R) * torch.from_numpy(g)).sum().backward()
    for leaf, ref in zip(leaves, want):
        ref = np.asarray(ref)
        assert np.linalg.norm(leaf.grad.numpy() - ref) <= 1e-5 * np.linalg.norm(ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_shift_model_head_maps_match_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    cfg = bf16_cfg()
    cfg.TPU.DCN_FORCE_IMPL = "shift"
    cfg.TPU.COMPUTE_DTYPE = dtype
    model = bf16_port_model(cfg).eval()
    set_compute_dtype(model.backbone, tdt)
    jmodel = JaxMonoFlex(backbone=JaxDLASeg(channels=NARROW_CHANNELS, dcn_impl="shift",
                                            dcn_max_offsets=STAGE_R, dtype=jdt),
                         predictor=jax_build_predictor(cfg))
    params, stats = to_flax(model, cfg)
    batch = make_inference_batch(B, H, W)
    fields = ("image", "edge_indices", "edge_len")
    ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        {"params": params, "batch_stats": stats}, *(jnp.asarray(batch[k]) for k in fields))
    with torch.no_grad():
        out = model(*(torch.from_numpy(batch[k]) for k in fields))
    pairs = [(out["cls"], ref["cls"])] + list(zip(out["reg"], ref["reg"]))
    assert len(pairs) == 10
    for got, want in pairs:
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=MAP_ATOL if tdt == torch.bfloat16 else ATOL, rtol=0)
