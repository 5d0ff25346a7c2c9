"""The port's ``fwd_ablate`` tool against the JAX package's
``tools/fwd_ablate.py``: every variant its main knows, each TPU builder in
interpret mode against the port's counterpart on the same numpy inputs.

- The stagings (full, hoistwx, fori, hoist3d, v15, packed, packedh3) are
  routes onto ``dcn_fwd`` at f32: 1e-4 abs on O(1) outputs (float32,
  summation order only).
- Their bf16 forms (foribf16, hoist3dbf16, v15bf16, packedbf16,
  packedh3bf16) are routes onto the bf16 window math: 3e-2 of the largest
  |output| (the TPU kernels also hold their window partial sums in bf16; at
  these inputs they lie 0.3-0.5% of the largest output from the f32 DCN).
- nomap and nobcast are the ablations of ``csrc/dcn_ablate.cu`` (plain
  versions here): 1e-4 abs on their O(10) outputs.  nobcast takes the
  maximum of each hat map over the row tile, so it also runs at H = 13 (one
  tile of 16 with 3 padded rows) and H = 40 (three tiles, the last with 8
  padded rows), where the padded rows' hats (offset 0, mask 0) count.

B=1, W=16, offsets pinned off integers (ROADMAP C1); C=Co=8, and C=Co=64
for the packed builders, which need it.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu_torch.tools import fwd_ablate
from test_torch_dcn import make_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import fwd_ablate as jax_fwd_ablate  # noqa: E402

ATOL = 1e-4
BF16_RTOL_OF_MAX = 3e-2
PACKED = ("packed", "packedh3")
STAGINGS = ("hoist3d", "v15") + PACKED
JAX_BUILDERS = {"packed": jax_fwd_ablate.build_packed, "packedh3": jax_fwd_ablate.build_packed_h3,
                "v15": jax_fwd_ablate.build_v15, "hoist3d": jax_fwd_ablate.build_hoist3d}


def jax_build(variant, shapes):
    """The function the JAX tool's main builds for ``variant`` (its builders
    run in interpret mode off the TPU)."""
    base = variant[:-4] if variant.endswith("bf16") else variant
    if base in JAX_BUILDERS:
        dtype = jnp.bfloat16 if variant.endswith("bf16") else jnp.float32
        return JAX_BUILDERS[base](shapes, compute_dtype=dtype)
    return jax_fwd_ablate.build_variant(variant, shapes)


CASES = ([(v, 16) for v in ("full", "hoistwx", "fori", "foribf16", "nomap", "nobcast")]
         + [(v + suffix, 16) for v in STAGINGS for suffix in ("", "bf16")]
         + [("nobcast", 13), ("nobcast", 40)])


@pytest.mark.parametrize("variant,H", CASES, ids=[f"{v}-H{h}" for v, h in CASES])
def test_variant_matches_tpu_kernel(variant, H):
    C = 64 if variant.startswith(PACKED) else 8
    shapes = (1, H, 16, C, C)
    arrays = make_inputs(seed=6, B=1, H=H, W=16, C=C, Co=C)[:4]
    ref = np.asarray(jax_build(variant, shapes)(*map(jnp.asarray, arrays)))
    out = fwd_ablate.build(variant, shapes)(*map(torch.from_numpy, arrays)).numpy()
    assert out.shape == ref.shape
    if variant.endswith("bf16"):
        assert np.abs(out - ref).max() <= BF16_RTOL_OF_MAX * np.abs(ref).max()
        f32 = fwd_ablate.build("full", shapes)(*map(torch.from_numpy, arrays)).numpy()
        assert np.abs(out - f32).max() > 1e-4, "bf16 math is a no-op"
    else:
        np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("builder", [fwd_ablate.build_packed, fwd_ablate.build_packed_h3])
@pytest.mark.parametrize("shapes", [(1, 8, 16, 32, 64), (1, 8, 16, 64, 32), (1, 8, 15, 64, 64)])
def test_packed_precondition(builder, shapes):
    with pytest.raises(ValueError, match="C = Co = 64 and W even"):
        builder(shapes)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        fwd_ablate.build("rowdot", (1, 8, 8, 8, 8))
