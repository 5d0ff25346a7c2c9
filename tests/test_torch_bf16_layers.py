"""The port's layers under a bf16 model (``TPU.COMPUTE_DTYPE`` "bfloat16")
against flax's, one module at a time, on the same inputs and weights.

- BatchNorm (flax ``BatchNorm(dtype=bfloat16)``): statistics reduced in f32,
  (x - mean) * rsqrt(var + eps) * scale + bias in f32, one cast to bf16; in
  train mode, in eval mode, and on the global-batch path of several
  processes (here one process through that path).  The output is held to
  one bf16 ulp of flax's (2^-8 relative; the f32 arithmetic before the cast
  differs in order, which moves an element across a rounding boundary
  rarely), the running statistics to 1e-6 relative, the input gradient to
  two bf16 ulps of its largest element (both sides round to bf16 at other
  points of the backward: each lies within 1.2 ulps of the float64 gradient,
  measured) and the scale and bias gradients to 1e-5 relative (f32 sums).
- Conv2d in bf16 with its bias added after the convolution, in bf16, as
  flax's ``Conv(dtype=bfloat16)``: one bf16 ulp (both accumulate in f32 and
  round once; the order of the sums differs).
- GroupNorm: flax's ``GroupNorm(num_groups=32)``, epsilon 1e-6, in f32 and
  in bf16: 1e-5 abs in f32, one bf16 ulp in bf16.
- The DCN block of a bf16 model: the offset/mask conv in bf16 cast to f32
  (bf16-quantised offsets), x handed to the DCN as the bf16 activation, f32
  out, then the BN's bf16 output, against the JAX ``DeformConvBlock`` with
  its v3 kernel replaced by its plain reference (the XLA gather on offsets
  clipped to +-R): the offsets exactly, the block output to one bf16 ulp.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed.nn.functional as dist_fn

import monoflex_tpu.ops.dcn_pallas_v3 as V3
from monoflex_tpu.models.backbone.dla import DeformConvBlock as JaxDeformConvBlock
from monoflex_tpu.ops.dcn import modulated_deform_conv as jax_gather
from monoflex_tpu_torch.models import batchnorm
from monoflex_tpu_torch.models.backbone.dla import DCNSpec, DeformConvBlock
from monoflex_tpu_torch.models.layers import Conv2d, GroupNorm, set_compute_dtype
from monoflex_tpu_torch.utils import comm

BF16_ULP = 2.0 ** -8


def bf16(a):
    """numpy f32 array rounded to bf16 values (still f32)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def to_nchw(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a)).to(dtype).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def assert_within_ulp(got, want, ulps=1, of_max=False):
    """Elementwise within ``ulps`` bf16 ulps of the larger magnitude (at
    least 1e-2 of the tensor's largest: an element near 0 comes out of a
    cancellation in f32, where the two sides' order of operations shows),
    or (``of_max``) of the largest magnitude in ``want``."""
    big = np.abs(want).max()
    scale = big if of_max else np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-2 * big)
    tol = ulps * BF16_ULP * scale + 1e-30
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{bad.sum()} elements off by more than {ulps} ulp: " \
                          f"{np.abs(got - want)[bad].max()}"


@pytest.fixture
def bn_inputs():
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 12, 10, 8) * 3 + 1.5).astype(np.float32)   # NHWC, off-centre
    return dict(x=bf16(x), g=rs.randn(2, 12, 10, 8).astype(np.float32),
                scale=(1 + 0.1 * rs.randn(8)).astype(np.float32),
                bias=(0.1 * rs.randn(8)).astype(np.float32),
                mean=(0.1 * rs.randn(8)).astype(np.float32),
                var=(0.5 + rs.rand(8)).astype(np.float32))


def flax_bn(inp, train, x_dtype):
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.bfloat16)
    stats = {"mean": jnp.asarray(inp["mean"]), "var": jnp.asarray(inp["var"])}

    def f(x, params):
        y, new = bn.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
        return (y.astype(jnp.float32) * inp["g"]).sum(), (y, new["batch_stats"])

    params = {"scale": jnp.asarray(inp["scale"]), "bias": jnp.asarray(inp["bias"])}
    x = jnp.asarray(inp["x"]).astype(x_dtype)
    (_, (y, new)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(x, params)
    return y, new, gx, gp


def port_bn(inp, train, x_dtype):
    m = batchnorm.BatchNorm2d(8, eps=1e-5)
    m.compute_dtype = torch.bfloat16
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(inp["scale"]))
        m.bias.copy_(torch.from_numpy(inp["bias"]))
        m.running_mean.copy_(torch.from_numpy(inp["mean"]))
        m.running_var.copy_(torch.from_numpy(inp["var"]))
    m.train(train)
    x = to_nchw(inp["x"], x_dtype).requires_grad_()
    y = m(x)
    (y.float() * to_nchw(inp["g"], torch.float32)).sum().backward()
    return m, x, y


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
def test_batchnorm_follows_flax_under_bf16(bn_inputs, train, x_dtype):
    """A trunk BN takes bf16 (its conv's output), a neck BN f32 (the DCN's)."""
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[x_dtype]
    y, new, gx, gp = flax_bn(bn_inputs, train, jdt)
    m, x, ty = port_bn(bn_inputs, train, tdt)
    assert ty.dtype == torch.bfloat16 and y.dtype == jnp.bfloat16
    assert m.weight.dtype == m.running_var.dtype == torch.float32
    assert_within_ulp(nhwc(ty), np.asarray(y.astype(jnp.float32)))
    assert x.grad.dtype == tdt
    assert_within_ulp(nhwc(x.grad), np.asarray(gx.astype(jnp.float32)), 2, of_max=True)
    np.testing.assert_allclose(m.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(m.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(new["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(new["var"]), rtol=1e-6)


def test_global_batch_batchnorm_under_bf16(bn_inputs, monkeypatch):
    """The several-process path (two all-reduces of f32 sums) with one
    process in the group: the same output and statistics as flax."""
    monkeypatch.setattr(comm, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist_fn, "all_reduce", lambda t: t)
    y, new, gx, _ = flax_bn(bn_inputs, True, jnp.bfloat16)
    m, x, ty = port_bn(bn_inputs, True, torch.bfloat16)
    assert ty.dtype == torch.bfloat16
    assert_within_ulp(nhwc(ty), np.asarray(y.astype(jnp.float32)))
    assert_within_ulp(nhwc(x.grad), np.asarray(gx.astype(jnp.float32)), 2, of_max=True)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(new["var"]), rtol=1e-6)


@pytest.mark.parametrize("bias", [False, True])
def test_conv_in_bf16_adds_its_bias_after(bias):
    rs = np.random.RandomState(1)
    x = bf16(rs.randn(2, 9, 11, 16).astype(np.float32))
    w = (rs.randn(3, 3, 16, 27) * 0.2).astype(np.float32)
    b = rs.randn(27).astype(np.float32)
    conv = fnn.Conv(27, (3, 3), padding=[(1, 1), (1, 1)], use_bias=bias, dtype=jnp.bfloat16)
    params = {"kernel": jnp.asarray(w), **({"bias": jnp.asarray(b)} if bias else {})}
    want = conv.apply({"params": params}, jnp.asarray(x).astype(jnp.bfloat16))
    c = Conv2d(16, 27, 3, padding=1, bias=bias)
    c.compute_dtype = torch.bfloat16
    with torch.no_grad():
        c.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        if bias:
            c.bias.copy_(torch.from_numpy(b))
    got = c(to_nchw(x, torch.float32))          # an f32 input is cast, as flax casts it
    assert got.dtype == torch.bfloat16
    assert_within_ulp(nhwc(got), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_groupnorm_is_flax_groupnorm(dtype):
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype]
    rs = np.random.RandomState(2)
    x = bf16((rs.randn(2, 6, 7, 64) * 2 + 0.5).astype(np.float32))
    scale = (1 + 0.1 * rs.randn(64)).astype(np.float32)
    bias = (0.1 * rs.randn(64)).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=32, dtype=jdt)
    want = gn.apply({"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
                    jnp.asarray(x).astype(jdt))
    m = GroupNorm(64)
    m.compute_dtype = tdt
    assert m.eps == 1e-6 and m.num_groups == 32
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    got = m(to_nchw(x, tdt))
    assert got.dtype == tdt
    if dtype == "f32":
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    else:
        assert_within_ulp(nhwc(got), np.asarray(want.astype(jnp.float32)))


def test_dcn_block_under_bf16(monkeypatch):
    """pallas3b in a bf16 model: bf16-quantised offsets, f32 DCN on the bf16
    activation, bf16 BN output."""
    def clipped(x, offset, mask, weight, bias, max_offset=2, transfer_dtype=None):
        return jax_gather(x, jnp.clip(offset, -max_offset, max_offset), mask, weight, bias)

    monkeypatch.setattr(V3, "dcn_pallas_v3_vjp", clipped)
    rs = np.random.RandomState(3)
    x = bf16(rs.randn(2, 8, 12, 16).astype(np.float32))
    jblock = JaxDeformConvBlock(24, dcn_impl="pallas3b", max_offset=2, dtype=jnp.bfloat16)
    variables = jax.jit(jblock.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    params["DCN_0"]["Conv_0"]["kernel"] = (rs.randn(3, 3, 16, 27) * 0.3).astype(np.float32)
    params["DCN_0"]["Conv_0"]["bias"] = rs.randn(27).astype(np.float32)
    stats = {"mean": (0.1 * rs.randn(24)).astype(np.float32),
             "var": (0.5 + rs.rand(24)).astype(np.float32)}
    (want, inter) = jblock.apply({"params": params, "batch_stats": {"BatchNorm_0": stats}},
                                 jnp.asarray(x).astype(jnp.bfloat16),
                                 mutable=["intermediates"])
    offsets = np.asarray(inter["intermediates"]["DCN_0"]["offset"][0])

    block = DeformConvBlock(16, 24, DCNSpec(2, torch.bfloat16, True, impl="pallas3b")).eval()
    set_compute_dtype(block, torch.bfloat16)
    dcn, bn = block.conv, block.actf[0]
    with torch.no_grad():
        dcn.weight.copy_(torch.from_numpy(params["DCN_0"]["kernel"]).permute(3, 2, 0, 1))
        dcn.bias.copy_(torch.from_numpy(params["DCN_0"]["bias"]))
        dcn.conv_offset_mask.weight.copy_(
            torch.from_numpy(params["DCN_0"]["Conv_0"]["kernel"]).permute(3, 2, 0, 1))
        dcn.conv_offset_mask.bias.copy_(torch.from_numpy(params["DCN_0"]["Conv_0"]["bias"]))
        bn.weight.copy_(torch.from_numpy(params["BatchNorm_0"]["scale"]))
        bn.bias.copy_(torch.from_numpy(params["BatchNorm_0"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    seen = []
    dcn.conv_offset_mask.register_forward_hook(lambda m, i, o: seen.append(o.float()))
    with torch.no_grad():
        got = block(to_nchw(x))
    port_offsets = nhwc(seen[0])[..., :18]
    np.testing.assert_array_equal(port_offsets, bf16(port_offsets))   # bf16 values
    assert (np.abs(port_offsets) > 2).any()                            # partly clamped
    np.testing.assert_array_equal(port_offsets, offsets)
    assert got.dtype == torch.bfloat16
    assert_within_ulp(nhwc(got), np.asarray(want.astype(jnp.float32)))
