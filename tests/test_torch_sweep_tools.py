"""The port's counterparts of the JAX sweep tools: ``BilinearUp``'s phase
form against its transposed-conv form and both JAX forms, and the command
lines of ``kernel_sweep``, ``bilinear_ablate``, ``run_v15_sweep.sh`` and
``bench_spread`` (their arguments, and their exit without a card).

BilinearUp runs at ``bilinear_ablate.SHAPES`` with the channels cut to 8,
at factors 2 and 4, on a seeded weight that is not the symmetric bilinear
init (so the kernel's orientation matters), f32: within 1e-5 abs, float32
sums of 4 products in another order.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.models.backbone.dla import BilinearUp as JaxBilinearUp
from monoflex_tpu_torch.models.backbone.dla import BilinearUp
from monoflex_tpu_torch.tools import kernel_sweep
from monoflex_tpu_torch.tools.bilinear_ablate import SHAPES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
CHANNELS = 8


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("shape", [s for s, _, _ in SHAPES], ids=str)
def test_phase_form_equals_the_transposed_conv_and_jax(shape, factor):
    B, H, W, _ = shape
    rng = np.random.RandomState(factor)
    x = rng.randn(B, H, W, CHANNELS).astype(np.float32)
    weight = (rng.rand(CHANNELS, 1, 2 * factor, 2 * factor) + 0.5).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    outs = {}
    for impl in BilinearUp.IMPLS:
        up = BilinearUp(CHANNELS, factor, impl=impl)
        with torch.no_grad():
            up.weight.copy_(torch.from_numpy(weight))
            outs[impl] = up(tx).permute(0, 2, 3, 1).numpy()
    assert outs["phase"].shape == (B, factor * H, factor * W, CHANNELS)
    np.testing.assert_allclose(outs["phase"], outs["dilated"], atol=ATOL)
    kernel = jnp.asarray(weight.transpose(2, 3, 1, 0))
    for impl in ("phase", "dilated"):
        ref = JaxBilinearUp(factor, impl=impl).apply({"params": {"kernel": kernel}}, x)
        for got in outs.values():
            np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


def test_bilinear_up_keeps_its_default_form():
    assert BilinearUp(8, 2).impl == "dilated"
    with pytest.raises(ValueError, match="impl"):
        BilinearUp(8, 2, impl="lhs")


def no_card(cmd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("cmd", [
    [sys.executable, "-m", "monoflex_tpu_torch.tools.kernel_sweep", "--shapes", "all",
     "--variants", "f32r2,bf16r1", "--what", "fwd,fwd2,dx,dwm,doff"],
    [sys.executable, "-m", "monoflex_tpu_torch.tools.bilinear_ablate"],
    ["bash", "monoflex_tpu_torch/tools/run_v15_sweep.sh", "output/v15_sweep_test.log"],
    [sys.executable, "-m", "monoflex_tpu_torch.tools.bench_spread", "--runs", "1"],
], ids=["kernel_sweep", "bilinear_ablate", "run_v15_sweep", "bench_spread"])
def test_tools_exit_non_zero_without_a_card(cmd):
    proc = no_card(cmd)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("cmd", [
    [sys.executable, "-m", "monoflex_tpu_torch.tools.kernel_sweep", "--help"],
    ["bash", "monoflex_tpu_torch/tools/run_v15_sweep.sh", "--help"],
], ids=["kernel_sweep", "run_v15_sweep"])
def test_help(cmd):
    proc = no_card(cmd)
    assert proc.returncode == 0 and proc.stdout


def test_kernel_sweep_rejects_unknown_names():
    """Argument errors come before the card check (argparse's exit 2)."""
    with pytest.raises(SystemExit) as exc:
        kernel_sweep.main(["--what", "fwd,dw"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        kernel_sweep.main(["--variants", "f16r2"])
    assert exc.value.code == 2


def test_kernel_sweep_times_the_jax_tools_kernels():
    """fwd, fwd2, dx, dwm and doff, on the port's kernels, chained on x."""
    assert kernel_sweep.WHAT == ("fwd", "fwd2", "dx", "dwm", "doff")
    g = torch.Generator().manual_seed(0)
    B, H, W, C = 1, 6, 7, 8
    x = torch.randn(B, H, W, C, generator=g)
    off = torch.randn(B, H, W, 18, generator=g)
    mask = torch.rand(B, H, W, 9, generator=g)
    w = torch.randn(3, 3, C, C, generator=g) * 0.1
    gy = torch.randn(B, H, W, C, generator=g)
    fns = kernel_sweep.kernels(torch.float32, 2, off, mask, w, torch.zeros(C), gy)
    assert sorted(fns) == sorted(kernel_sweep.WHAT)
    for name, fn in fns.items():
        assert fn(x).shape == x.shape, name
    assert torch.equal(fns["fwd"](x), fns["fwd2"](x))
    assert not torch.equal(fns["dwm"](x), fns["doff"](x))
