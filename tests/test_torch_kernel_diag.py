"""The port's ``kernel_diag`` tool against the JAX package's
``tools/kernel_diag.py``.

Every ``kernel_diag`` variant (full and rowdot are the DCN on ``dcn_fwd``;
dma, window, aligned and matmul the ablations of ``csrc/dcn_ablate.cu``,
here their plain versions) against the TPU kernel ``run_variant`` in
interpret mode, at R 1 and 2, on the same numpy inputs: B=1, H=16, W=16,
C=Co=8, offsets pinned off integers (ROADMAP C1).  Tolerance 1e-4 abs on
outputs of O(1) to O(10): float32 on both sides, summation order only (the
TPU kernel also sums its column hats, which the port's aligned takes as 1).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu_torch.tools import kernel_diag
from test_torch_dcn import interpret_mode, make_inputs  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import kernel_diag as jax_kernel_diag  # noqa: E402

ATOL = 1e-4
VARIANTS = ["full", "rowdot", "dma", "window", "aligned", "matmul"]


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_tpu_kernel(interpret_mode, variant, R):
    arrays = make_inputs(seed=5, B=1, H=16, W=16, C=8, Co=8)[:4]
    ref = np.asarray(jax_kernel_diag.run_variant(*map(jnp.asarray, arrays), R, variant))
    out = kernel_diag.run_variant(*map(torch.from_numpy, arrays), R, variant).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_unknown_variant_raises():
    arrays = map(torch.from_numpy, make_inputs(seed=5, B=1, H=8, W=8, C=8, Co=8)[:4])
    with pytest.raises(ValueError, match="variant"):
        kernel_diag.run_variant(*arrays, 2, "nomap")


def test_serial_chain_record():
    """The timing loop on the CPU: a record with compile_s and ms."""
    arrays = map(torch.from_numpy, make_inputs(seed=5, B=1, H=8, W=8, C=8, Co=8)[:4])
    rec = kernel_diag.measure(*arrays, 2, "window", iters=2)
    assert set(rec) == {"compile_s", "ms"} and rec["ms"] >= 0
