"""The relayout of the TPU's transpose ablation and the tools' shells.

- ``ops/relayout.py``: the port's relayout (plain version on the CPU; the
  kernel ``csrc/relayout.cu`` on the card) against the TPU kernels
  ``pallas_variant`` and ``pallasT_variant`` of ``tools/transpose_ablate.py``
  in interpret mode, and the ``xla`` and ``dot`` variants against theirs.
  Pure data movement: they match exactly.  H divisible by 8, as the JAX
  grid covers only H // 8 * 8 rows.
- ``kernel_bench.MODEL_SHAPES`` keeps the JAX list's order with its two
  wrong rows corrected (ROADMAP C7): its set is the set of (H, W, C, Co) of
  the model's 16 DCN layers at 384x1280.
- Each tool's entry point exits non-zero without a CUDA device.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.models.backbone.dla import DCN
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.ops.relayout import relayout, relayout_dims
from monoflex_tpu_torch.tools import kernel_bench, transpose_ablate
from monoflex_tpu_torch.tools.trace_time import trace_is_whole
from test_torch_dcn import interpret_mode  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import kernel_bench as jax_kernel_bench  # noqa: E402
import transpose_ablate as jax_transpose_ablate  # noqa: E402

TOOLS = ["kernel_bench", "kernel_diag", "fwd_ablate", "transpose_ablate"]


def relayout_input(B=2, H=16, W=20, C=6, seed=0):
    return np.random.RandomState(seed).randn(B, H, W, C).astype(np.float32)


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("name", ["pallas", "pallasT"])
def test_relayout_matches_tpu_kernel(interpret_mode, name, R):
    x = relayout_input()
    ref = np.asarray(getattr(jax_transpose_ablate, f"{name}_variant")(jnp.asarray(x), R=R))
    out = relayout(torch.from_numpy(x), R).numpy()
    _, _, wp2f, Cs = relayout_dims(16, 20, 6, R)
    assert out.shape == ref.shape == (2, 16, Cs, wp2f)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", ["xla", "dot"])
def test_plain_variants_match_jax(name):
    x = relayout_input(seed=1)
    ref = np.asarray(getattr(jax_transpose_ablate, f"{name}_variant")(jnp.asarray(x)))
    out = transpose_ablate.VARIANTS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_relayout_places_every_element():
    """out[b, h, c, P + w] = x[b, h, w, c], zeros elsewhere, at a shape with
    C off the multiple of 8 and H off the multiple of 8 (every row defined)."""
    x = torch.from_numpy(relayout_input(B=1, H=13, W=5, C=3, seed=2))
    P, _, wp2f, Cs = relayout_dims(13, 5, 3, 2)
    out = relayout(x, 2)
    assert tuple(out.shape) == (1, 13, Cs, wp2f)
    assert torch.equal(out[:, :, :3, P:P + 5], x.permute(0, 1, 3, 2))
    out[:, :, :3, P:P + 5] = 0
    assert not out.any()
    assert transpose_ablate.max_err("pallas", relayout(x, 2), transpose_ablate.xla_variant(x)) == 0


def test_model_shapes_are_the_models_dcn_shapes():
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
    model = build_model(cfg, device="cpu", seed=0)
    seen = []
    for m in model.modules():
        if isinstance(m, DCN):
            m.register_forward_pre_hook(
                lambda mod, inp: seen.append((*inp[0].shape[2:], inp[0].shape[1],
                                              mod.weight.shape[0])))
    with torch.no_grad():
        model.backbone(torch.zeros(1, 3, 384, 1280))
    assert len(seen) == 16
    assert set(seen) == set(kernel_bench.MODEL_SHAPES)
    # the JAX list's order and its other rows are kept
    jax_shapes = jax_kernel_bench.MODEL_SHAPES
    assert len(kernel_bench.MODEL_SHAPES) == len(jax_shapes)
    changed = [i for i, (a, b) in enumerate(zip(kernel_bench.MODEL_SHAPES, jax_shapes)) if a != b]
    assert changed == [1, 6]


def test_bench_record_on_cpu():
    """kernel_bench's record of one shape, forward and backward, at a tiny
    size on the CPU (the plain op): the JAX tool's keys and finite times."""
    rec = kernel_bench.measure("bf16r1", (8, 8, 8, 8), batch=1, iters=1, bwd=True,
                               rng=np.random.RandomState(0), device="cpu")
    assert {"fwd_ms", "fwd_compile_s", "bwd_ms", "bwd_compile_s"} <= set(rec), rec
    assert rec["variant"] == "bf16r1" and rec["shape"] == [8, 8, 8, 8]
    assert kernel_bench.pick_shapes("0,4") == [kernel_bench.MODEL_SHAPES[0],
                                               kernel_bench.MODEL_SHAPES[4]]


@pytest.mark.parametrize("tool", TOOLS)
def test_entry_point_needs_cuda(tool, tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", f"monoflex_tpu_torch.tools.{tool}", "--iters", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("counts, whole", [
    ({"dcn_fwd": 3, "memset": 6}, True),
    ({"dcn_fwd": 1}, False),            # a trace that kept 1 of 3 launches
    ({}, False),                        # a trace with no device record
    ({"dcn_fwd": 3, "tile_max": 2}, False),
])
def test_trace_time_takes_only_whole_traces(counts, whole):
    assert trace_is_whole(counts, 3) is whole
