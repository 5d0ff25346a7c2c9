"""The fused eval BN+ReLU epilogue of the DCN forward (TPU.DCN_FUSE_BN_RELU).

- The plain fused op, and the kernel wrapper's CPU path, against
  ``dcn_pallas_v3(..., epilogue=(scale, shift))`` in interpret mode.
- An eval-mode ``DeformConvBlock`` with the fusion against the JAX block with
  its fusion switched on (``_FUSE_BN_RELU``), on the same weights through the
  parameter bridge's name map and layout converter; train mode keeps the
  real BN; the state dict does not change.
- The wrapper is inference-only and checks its epilogue operands.

Tolerance 1e-5 abs: float32 on both sides, O(1) outputs, summation order
only; the epilogue folds the BN into scale and shift, which moves a result
by about 1e-7 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monoflex_tpu.models.backbone.dla as JD
import monoflex_tpu.ops.dcn_pallas_v3 as DP3
from monoflex_tpu_torch.models.backbone.dla import DCNSpec, DeformConvBlock
from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import modulated_deform_conv_bn_relu
from monoflex_tpu_torch.utils.param_bridge import _deform_conv, _to_torch_layout, flatten_params
from test_torch_dcn import interpret_mode, make_inputs  # noqa: F401 (fixture)

ATOL = 1e-5
TRANSFER = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, jnp.bfloat16)}


def epilogue(Co, seed):
    rng = np.random.RandomState(seed)
    return ((1 + 0.3 * rng.randn(Co)).astype(np.float32),
            (0.2 * rng.randn(Co)).astype(np.float32))


@pytest.mark.parametrize("transfer", ["f32", "bf16"])
def test_plain_fused_op_matches_pallas_v3_epilogue(interpret_mode, transfer):
    x, off, mask, w, _ = make_inputs(seed=6, H=8, W=16, C=16, Co=16)
    scale, shift = epilogue(16, seed=7)
    torch_dtype, jax_dtype = TRANSFER[transfer]
    ref = np.asarray(DP3.dcn_pallas_v3(*map(jnp.asarray, (x, off, mask, w)), None, max_offset=2,
                                       transfer_dtype=jax_dtype,
                                       epilogue=(jnp.asarray(scale), jnp.asarray(shift))))
    assert (ref == 0).mean() > 0.2, "the ReLU clips part of the output"
    args = [torch.from_numpy(a) for a in (x, off, mask, w, scale, shift)]
    kw = dict(max_offset=2, transfer_dtype=torch_dtype)
    np.testing.assert_allclose(modulated_deform_conv_bn_relu(*args, **kw).numpy(), ref, atol=ATOL)
    before = dcn_cuda.dcn_forward_bn_relu.launches
    with torch.no_grad():
        np.testing.assert_allclose(dcn_cuda.dcn_forward_bn_relu(*args, **kw).numpy(), ref,
                                   atol=ATOL)
    assert dcn_cuda.dcn_forward_bn_relu.launches == before


def block_variables(cin, cout, seed):
    """Flax variables of one DeformConvBlock, seeded, in the JAX layout."""
    rng = np.random.RandomState(seed)
    params = {"DCN_0": {"Conv_0": {"kernel": rng.randn(3, 3, cin, 27).astype(np.float32) * 0.2,
                                   "bias": rng.randn(27).astype(np.float32) * 0.5},
                        "kernel": rng.randn(3, 3, cin, cout).astype(np.float32) * 0.2,
                        "bias": rng.randn(cout).astype(np.float32) * 0.3},
              "BatchNorm_0": {"scale": (1 + 0.2 * rng.randn(cout)).astype(np.float32),
                              "bias": (0.2 * rng.randn(cout)).astype(np.float32)}}
    stats = {"BatchNorm_0": {"mean": (0.3 * rng.randn(cout)).astype(np.float32),
                             "var": (0.5 + rng.rand(cout)).astype(np.float32)}}
    return params, stats


def port_block(params, stats, cin, cout, fuse):
    """The port's block with the flax variables loaded through the bridge's
    name map (``blk`` for both scopes) and layout converter."""
    block = DeformConvBlock(cin, cout, DCNSpec(2, torch.float32, True, fuse_bn_relu=fuse))
    flat = {False: flatten_params({"blk": params}), True: flatten_params({"blk": stats})}
    state = {}
    for torch_name, flax_path in _deform_conv("blk", "blk").items():
        is_stat = flax_path.startswith("stats:")
        value = flat[is_stat][flax_path.split(":")[-1]]
        state[torch_name[len("blk."):]] = torch.from_numpy(np.array(_to_torch_layout(value)))
    state["actf.0.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    block.load_state_dict(state, strict=True)
    return block.eval()


@pytest.fixture(scope="module")
def block_case():
    cin, cout = 8, 16
    x = np.random.RandomState(8).randn(1, 8, 16, cin).astype(np.float32)
    params, stats = block_variables(cin, cout, seed=9)
    return x, params, stats, cin, cout


def test_fused_block_matches_jax_fused_block(interpret_mode, block_case, monkeypatch):
    x, params, stats, cin, cout = block_case
    monkeypatch.setattr(JD, "_FUSE_BN_RELU", True)
    ref = np.asarray(JD.DeformConvBlock(cout, dcn_impl="pallas3", max_offset=2).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    block = port_block(params, stats, cin, cout, fuse=True)
    before = dcn_cuda.dcn_forward_bn_relu.launches
    with torch.no_grad():
        out = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    assert 0 < (out == 0).mean() < 1
    assert dcn_cuda.dcn_forward_bn_relu.launches == before     # CPU: the plain op


def test_fusion_keeps_the_state_dict_and_train_mode(block_case):
    x, params, stats, cin, cout = block_case
    fused = port_block(params, stats, cin, cout, fuse=True)
    plain = port_block(params, stats, cin, cout, fuse=False)
    assert fused.state_dict().keys() == plain.state_dict().keys()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        np.testing.assert_allclose(fused(xt).numpy(), plain(xt).numpy(), atol=ATOL)
        fused.train()
        plain.train()
        assert torch.equal(fused(xt), plain(xt))


def test_fused_op_is_inference_only_and_checks_its_operands():
    x, off, mask, w, _ = [torch.from_numpy(a) for a in make_inputs(seed=10, H=4, W=6)]
    scale, shift = [torch.from_numpy(a) for a in epilogue(8, seed=11)]
    w.requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        dcn_cuda.dcn_forward_bn_relu(x, off, mask, w, scale, shift, max_offset=2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="scale"):
            dcn_cuda.dcn_forward_bn_relu(x, off, mask, w, scale[:4], shift, max_offset=2)
        with pytest.raises(ValueError, match="shift"):
            dcn_cuda.dcn_forward_bn_relu(x, off, mask, w, scale, shift.double(), max_offset=2)
