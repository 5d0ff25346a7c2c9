"""The bf16 window math (``compute_dtype=bfloat16`` of the v1/v2 TPU kernels:
x, W and g rounded to bf16, each corner weight times the mask and each
sampled value rounded, f32 accumulation) in the port's plain op, its
backward and ``DCNFunction``'s CPU path, against ``dcn_pallas``,
``dcn_pallas_v2`` and ``dcn_pallas_bwd_dx/_dwm/_doff`` with
``compute_dtype=bfloat16`` in interpret mode.

B=1, H=16, W=16, C=Co=8, R=2, offsets pinned off integers (ROADMAP C1).
The backward's comparisons are in ``test_torch_bf16_math_bwd.py`` (a file of
their own, so that the test workers run the two halves in parallel).
Tolerance: 3e-2 of the largest |output| of the JAX kernel.  The TPU kernels
round at other points as well (their window partial sums and u = W g are
held in bf16) and sum in another order; at these inputs they lie about
0.5% of the largest output from their own float32 result.  The bf16 result
must also differ from the port's float32 result by more than 1e-4, so that
the mode is not a no-op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monoflex_tpu.ops.dcn_pallas as DP1
import monoflex_tpu.ops.dcn_pallas_v2 as DP2
from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import modulated_deform_conv, modulated_deform_conv_backward
from test_torch_dcn import interpret_mode, make_inputs  # noqa: F401 (fixture)

R = 2
RTOL_OF_MAX = 3e-2
NOT_NOOP = 1e-4
BF16 = torch.bfloat16


def inputs(seed=30):
    x, off, mask, w, b = make_inputs(seed=seed, B=1, H=16, W=16, C=8, Co=8)
    g = np.random.RandomState(seed + 1).randn(1, 16, 16, 8).astype(np.float32)
    return x, off, mask, w, b, g


def close(port, ref):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(port) - ref).max()
    assert err <= RTOL_OF_MAX * np.abs(ref).max(), (err, np.abs(ref).max())


def torch_args(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def port():
    """The port's bf16-math and f32 forward and gradients: plain op and the
    autograd Function's CPU path."""
    x, off, mask, w, b, g = torch_args(*inputs())
    out = {}
    for name, dtype in (("bf16", BF16), ("f32", torch.float32)):
        y = modulated_deform_conv(x, off, mask, w, b, max_offset=R, compute_dtype=dtype)
        grads = modulated_deform_conv_backward(x, off, mask, w, g, max_offset=R,
                                               compute_dtype=dtype)
        out[name] = [t.numpy() for t in (y,) + grads[:4]]
    leaves = [t.clone().requires_grad_() for t in (x, off, mask, w)]
    yf = dcn_cuda.dcn_forward(*leaves, b, max_offset=R, compute_dtype=BF16)
    out["function"] = [t.detach().numpy() for t in (yf,) + torch.autograd.grad(yf, leaves, g)]
    return out


@pytest.mark.parametrize("fn", [DP1.dcn_pallas, DP2.dcn_pallas_v2], ids=["v1", "v2"])
def test_forward_matches_jax_bf16(interpret_mode, port, fn):
    x, off, mask, w, b, _ = inputs()
    ref = fn(*map(jnp.asarray, (x, off, mask, w, b)), max_offset=R, compute_dtype=jnp.bfloat16)
    for side in ("bf16", "function"):
        close(port[side][0], ref)


@pytest.mark.parametrize("i", range(5), ids=["y", "dx", "doffset", "dmask", "dweight"])
def test_bf16_math_is_not_a_noop(port, i):
    assert np.abs(port["bf16"][i] - port["f32"][i]).max() > NOT_NOOP


def test_function_equals_plain(port):
    """DCNFunction's CPU path under bf16 math is the plain op and its backward."""
    for got, ref in zip(port["function"], port["bf16"]):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_compute_dtype_is_checked():
    x, off, mask, w, b, _ = torch_args(*inputs())
    with pytest.raises(ValueError, match="compute_dtype"):
        modulated_deform_conv(x, off, mask, w, b, max_offset=R, compute_dtype=torch.float16)
