"""The port's FLOP counter (``tools/flops.py``, torch.utils.flop_counter with
the plain DCN) against the JAX tool's count (XLA's cost model on the CPU,
``tools/flops.py``'s method) of the same model at 64x128.

Tolerance 5%: the torch counter counts the convolutions and matrix products
(2 per multiply-add), XLA's cost model also the elementwise operations and
counts the transposed depthwise upsampling and the gather DCN's product as
its own lowering forms them; at this size the two lie 2% apart.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from monoflex_tpu.config import get_cfg_defaults as jax_cfg_defaults
from monoflex_tpu.data.synthetic import make_dummy_batch
from monoflex_tpu.models.detector import build_model as jax_build_model
from monoflex_tpu_torch.tools.flops import (H100_PEAK_BF16_TFLOPS, H100_PEAK_F32_TFLOPS,
                                            count_flops, report)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 128


@pytest.fixture(scope="module")
def counts():
    torch.set_num_threads(2)
    return count_flops(1, H, W, device="cpu")


def test_forward_count_is_xlas(counts):
    cfg = jax_cfg_defaults()
    cfg.merge_from_file(os.path.join(REPO, "runs", "monoflex.yaml"))
    cfg.TPU.DCN_FORCE_IMPL = "gather"
    model = jax_build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in make_dummy_batch(1, H, W).items()}
    inputs = (batch["image"], batch["edge_indices"], batch["edge_len"])
    variables = jax.jit(lambda key, *a: model.init(key, *a, train=False))(
        jax.random.PRNGKey(0), *inputs)
    cost = jax.jit(lambda v, *a: model.apply(v, *a, train=False)).lower(
        variables, *inputs).compile().cost_analysis()
    xla = float(cost["flops"])
    assert counts[0] == pytest.approx(xla, rel=0.05)


def test_train_step_counts_forward_and_backward(counts):
    """The backward takes about twice the forward's products."""
    fwd, train = counts
    assert 2.5 * fwd < train < 3.5 * fwd


def test_report_has_the_jax_keys_and_h100_peaks():
    out = report(2e9, 6e9, 100.0, 10.0)
    assert list(out) == ["fwd_gflops_per_img", "train_gflops_per_img",
                         "bytes_accessed_fwd_gb_per_img", "inference", "train"]
    assert out["inference"] == {"img_s": 100.0, "achieved_tflops": 0.2,
                                "mfu_vs_f32_peak_pct": round(20 / H100_PEAK_F32_TFLOPS, 2),
                                "mfu_vs_bf16_peak_pct": round(20 / H100_PEAK_BF16_TFLOPS, 2)}
    assert (H100_PEAK_F32_TFLOPS, H100_PEAK_BF16_TFLOPS) == (67.0, 989.0)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the exit without a card")
def test_exits_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "MONOFLEX_PLATFORM"}
    r = subprocess.run([sys.executable, "-m", "monoflex_tpu_torch.tools.flops"], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**env, "PYTHONPATH": REPO})
    assert r.returncode != 0 and "CUDA card" in r.stderr
