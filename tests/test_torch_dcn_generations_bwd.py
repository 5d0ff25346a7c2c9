"""The v1 and v2 TPU generations' dmask, dW and doffset kernels (split and
fused, plain and lane-packed) in interpret mode against the port's plain
backward and ``DCNFunction``'s CPU path, the gradients the port's Hopper
kernels serve for impls "pallas", "pallas2" and "pallas2p".  Inputs as in
``test_torch_dcn_generations.py`` (B=1, H=8, W=16, C=Co=64, offsets off
integers).

Tolerances: dmask and doffset 5e-5 abs (sums over 64 channels of products
of O(1) terms, float32, summation order); dW 1e-5 of its largest element (it
sums over every pixel).
"""

import numpy as np
import pytest

import monoflex_tpu.ops.dcn_pallas_bwd as DB1
import monoflex_tpu.ops.dcn_pallas_v2 as DP2
from test_torch_dcn import interpret_mode  # noqa: F401 (fixture)
from test_torch_dcn_generations import R, jax_inputs, port_results  # noqa: F401 (fixture)

ATOL = 5e-5
DW_RTOL = 1e-5


def check(port_results, dmask=None, dweight=None, doffset=None):
    for side in ("plain", "function"):
        _, _, doff, dm, dw = port_results[side]
        if dmask is not None:
            np.testing.assert_allclose(dm, np.asarray(dmask), atol=ATOL, err_msg=side)
        if doffset is not None:
            np.testing.assert_allclose(doff, np.asarray(doffset), atol=ATOL, err_msg=side)
        if dweight is not None:
            dweight = np.asarray(dweight)
            assert np.abs(dw - dweight).max() <= DW_RTOL * np.abs(dweight).max(), side


@pytest.mark.parametrize("fn", [DB1.dcn_pallas_bwd_dwm, DP2.dcn_pallas_v2_bwd_dwm],
                         ids=["v1", "v2"])
def test_dmask_dweight_match_port(interpret_mode, port_results, fn):
    x, off, mask, w, _, g = jax_inputs()
    dmask, dweight = fn(x, off, mask, w, g, max_offset=R)
    check(port_results, dmask=dmask, dweight=dweight)


@pytest.mark.parametrize("fn", [DB1.dcn_pallas_bwd_doff, DP2.dcn_pallas_v2_bwd_doff],
                         ids=["v1", "v2"])
def test_doffset_matches_port(interpret_mode, port_results, fn):
    x, off, mask, w, _, g = jax_inputs()
    check(port_results, doffset=fn(x, off, mask, w, g, max_offset=R))


@pytest.mark.parametrize("fn", [DP2.dcn_pallas_v2_bwd_dwmo, DP2.dcn_pallas_v2_packed_bwd_dwmo],
                         ids=["v2", "v2_packed"])
def test_fused_dwmo_matches_port(interpret_mode, port_results, fn):
    x, off, mask, w, _, g = jax_inputs()
    dmask, dweight, doffset = fn(x, off, mask, w, g, max_offset=R)
    check(port_results, dmask=dmask, dweight=dweight, doffset=doffset)
