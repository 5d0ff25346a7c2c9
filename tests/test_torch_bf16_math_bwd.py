"""The backward of the bf16 window math (see ``test_torch_bf16_math.py``):
the port's plain backward and ``DCNFunction``'s CPU path at
``compute_dtype=bfloat16`` against ``dcn_pallas_bwd_dx``, ``_dwm`` and
``_doff`` with ``compute_dtype=bfloat16`` in interpret mode, on the same
inputs (B=1, H=16, W=16, C=Co=8, R=2, offsets off integers).

Tolerance: 3e-2 of the largest |gradient| of the JAX kernel, as for the
forward.  The TPU kernels also hold u = W g and their window partial sums in
bf16, and sum in another order; dW sums over every pixel.
"""

import jax.numpy as jnp
import pytest

import monoflex_tpu.ops.dcn_pallas_bwd as DB1
from test_torch_bf16_math import R, close, inputs, port  # noqa: F401 (fixture)
from test_torch_dcn import interpret_mode  # noqa: F401 (fixture)


@pytest.mark.parametrize("grad", ["dx", "dmask_dweight", "doffset"])
def test_backward_matches_jax_bf16(interpret_mode, port, grad):
    x, off, mask, w, _, g = map(jnp.asarray, inputs())
    kw = dict(max_offset=R, compute_dtype=jnp.bfloat16)
    for side in ("bf16", "function"):
        _, dx, doff, dmask, dw = port[side]
        if grad == "dx":
            close(dx, DB1.dcn_pallas_bwd_dx(x, off, mask, w, g, **kw))
        elif grad == "doffset":
            close(doff, DB1.dcn_pallas_bwd_doff(x, off, mask, w, g, **kw))
        else:
            ref_dmask, ref_dw = DB1.dcn_pallas_bwd_dwm(x, off, mask, w, g, **kw)
            close(dmask, ref_dmask)
            close(dw, ref_dw)
