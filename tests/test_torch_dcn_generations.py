"""The v1 and v2 TPU kernel generations (impls "pallas", "pallas2",
"pallas2p", or TPU.DCN_KERNEL_VERSION 1 and 2) compute the same function as
the v3 kernels without bf16 transfer, so the port serves them with its
Hopper kernels at float32 transfer.  Here: their forward and dx kernels in
interpret mode against the port's plain op and ``DCNFunction``'s CPU path,
and the config routes.  The dmask/dW/doffset kernels are in
``test_torch_dcn_generations_bwd.py``.

B=1, H=8, W=16, C=Co=64, so the lane-packed v2 variants (C=Co=64, even W)
engage; offsets pinned off integers (ROADMAP C1).  Tolerance 1e-5 abs on the
forward and dx: float32 on both sides, summation order only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monoflex_tpu.ops.dcn_pallas as DP1
import monoflex_tpu.ops.dcn_pallas_bwd as DB1
import monoflex_tpu.ops.dcn_pallas_v2 as DP2
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.models.backbone.dla import resolve_dcn_specs
from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import modulated_deform_conv, modulated_deform_conv_backward
from test_torch_dcn import interpret_mode, make_inputs  # noqa: F401 (fixture)

R = 2
ATOL = 1e-5
SHAPE = dict(B=1, H=8, W=16, C=64, Co=64)


def generation_inputs(seed):
    x, off, mask, w, b = make_inputs(seed=seed, **SHAPE)
    g = np.random.RandomState(seed + 100).randn(*x.shape[:3], w.shape[-1]).astype(np.float32)
    return x, off, mask, w, b, g


@pytest.fixture(scope="module")
def port_results():
    """The port's forward and gradients, plain op and autograd Function:
    {"plain": (y, dx, doffset, dmask, dweight), "function": (...)}."""
    x, off, mask, w, b, g = [torch.from_numpy(a) for a in generation_inputs(seed=20)]
    y = modulated_deform_conv(x, off, mask, w, b, max_offset=R)
    plain = (y,) + modulated_deform_conv_backward(x, off, mask, w, g, max_offset=R)[:4]
    leaves = [t.clone().requires_grad_() for t in (x, off, mask, w)]
    yf = dcn_cuda.dcn_forward(*leaves, b, max_offset=R, transfer_dtype=torch.float32)
    function = (yf.detach(),) + torch.autograd.grad(yf, leaves, g)
    return {k: [t.numpy() for t in v] for k, v in (("plain", plain), ("function", function))}


def jax_inputs():
    return [jnp.asarray(a) for a in generation_inputs(seed=20)]


@pytest.mark.parametrize("fn", [DP1.dcn_pallas, DP2.dcn_pallas_v2, DP2.dcn_pallas_v2_packed],
                         ids=["v1", "v2", "v2_packed"])
def test_forward_matches_port(interpret_mode, port_results, fn):
    x, off, mask, w, b, _ = jax_inputs()
    ref = np.asarray(fn(x, off, mask, w, b, max_offset=R))
    for side in ("plain", "function"):
        np.testing.assert_allclose(port_results[side][0], ref, atol=ATOL, err_msg=side)


@pytest.mark.parametrize("fn", [DB1.dcn_pallas_bwd_dx, DP2.dcn_pallas_v2_bwd_dx,
                                DP2.dcn_pallas_v2_packed_bwd_dx],
                         ids=["v1", "v2", "v2_packed"])
def test_dx_matches_port(interpret_mode, port_results, fn):
    x, off, mask, w, _, g = jax_inputs()
    ref = np.asarray(fn(x, off, mask, w, g, max_offset=R))
    for side in ("plain", "function"):
        np.testing.assert_allclose(port_results[side][1], ref, atol=ATOL, err_msg=side)


@pytest.mark.parametrize("setting", [("TPU.DCN_KERNEL_VERSION", 1), ("TPU.DCN_KERNEL_VERSION", 2),
                                     ("TPU.DCN_FORCE_IMPL", "pallas"),
                                     ("TPU.DCN_FORCE_IMPL", "pallas2"),
                                     ("TPU.DCN_FORCE_IMPL", "pallas2p")])
def test_generations_route_to_the_float32_kernels(setting):
    cfg = get_cfg_defaults()
    cfg.merge_from_list(list(setting))
    cfg.TPU.DCN_FUSE_BN_RELU = True        # the JAX model fuses only into v3
    specs = resolve_dcn_specs(cfg)
    assert len(specs) == 4
    for spec in specs:
        assert spec.use_kernel and spec.transfer_dtype == torch.float32
        assert spec.max_offset == cfg.TPU.DCN_MAX_OFFSET and not spec.fuse_bn_relu


@pytest.mark.parametrize("impl", ["pallas4", "gather", "none"])
def test_unknown_impls_are_refused(impl):
    cfg = get_cfg_defaults()
    cfg.TPU.DCN_FORCE_IMPL = impl
    with pytest.raises(NotImplementedError, match=impl):
        resolve_dcn_specs(cfg)
