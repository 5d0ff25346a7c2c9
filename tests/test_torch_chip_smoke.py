"""chip_smoke.py has no CPU fallback: without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.
Its bounds count the work each kernel's function needs."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""     # hide any card
    return subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def load_smoke():
    """chip_smoke as a module: importing it runs nothing on a device."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_fails_without_a_gpu():
    proc = run_smoke(ROOT, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = run_smoke(tmp_path, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("kind", ["fwd", "dx", "dwmo"])
def test_bf16_math_bound_counts_products_on_tensor_cores(kind):
    """The bf16 window math's products are bf16 x bf16 summed in f32: its
    bound counts them at the tensor cores' rate, the sampling at f32."""
    smoke = load_smoke()
    H, W, C, Co = 96, 320, 64, 64
    ops, nbytes, tc = smoke.dcn_work(kind, H, W, C, Co, 4)
    s_ops, s_bytes, s_tc = smoke.dcn_work(kind, H, W, C, Co, 4, bf16_math=True)
    products = (2 if kind == "dwmo" else 1) * 2 * 9 * smoke.BATCH * H * W * C * Co
    if kind == "dx":     # f32 math off the tensor cores
        assert (tc, s_bytes, s_tc, s_ops) == (0, nbytes, products, ops - products)
    else:                # f32 math as split-bf16 passes, bf16 math as one
        assert (tc, s_bytes, s_tc, s_ops) == (smoke.TC_PASSES[kind] * products, nbytes,
                                              products, ops)
    t_ops = max(s_ops / smoke.F32_PEAK_FLOPS, s_tc / smoke.BF16_TC_PEAK_FLOPS)
    bound, by = smoke.bound_of(s_ops, s_bytes, s_tc)
    assert bound == pytest.approx(max(t_ops, s_bytes / smoke.HBM_BYTES_PER_S) * 1e3)
    assert bound < smoke.bound_of(ops, nbytes, tc)[0] and by in ("bytes", "operations")


def neck_bound(smoke, kind, bf16_math=False):
    """bound_ms of one kind summed over the neck's 16 DCN layers, x in f32
    as chip_smoke.py hands it to the kernels (dcn_fwd rounds it in the
    kernel; the bf16-math check counts it as given)."""
    work = [0, 0, 0]
    for (H, W, C, Co), layers in smoke.DCN_SHAPES:
        one = smoke.dcn_work(kind, H, W, C, Co, 4, bf16_math=bf16_math)
        work = [t + layers * v for t, v in zip(work, one)]
    return smoke.bound_of(*work)


@pytest.mark.parametrize("kind,want_ms,by", [("fwd", 1.29, "operations"),
                                             ("fwd_bn_relu", 1.29, "operations"),
                                             ("dwmo", 1.29, "operations"),
                                             ("dx", 3.33, "operations")])
def test_neck_bounds_count_tensor_core_passes(kind, want_ms, by):
    """dcn_fwd and its epilogue form take their f32-class product as 6
    passes of 3-part split-bf16 operands on the tensor cores (989 TFLOP/s),
    dcn_bwd_dwmo its two products as 3 passes of 2-part operands: 1.29 ms
    each over the neck's 16 layers at batch 8 (3 passes of the forward's
    one product would be 0.646 ms); dcn_bwd_dx, still f32 FMAs, keeps its
    f32 bound of 3.33 ms."""
    smoke = load_smoke()
    bound, got_by = neck_bound(smoke, kind)
    assert round(bound, 3 if bound < 1 else 2) == want_ms and got_by == by


@pytest.mark.parametrize("kind,want_ms", [("fwd", 0.372), ("dx", 0.372), ("dwmo", 0.578)])
def test_bf16_math_neck_bounds_count_one_pass(kind, want_ms):
    """Under bf16 math the operands are bf16 already: one tensor-core pass,
    so the bytes (fwd, dx) or the f32 sampling (dwmo) bound it."""
    smoke = load_smoke()
    bound, _ = neck_bound(smoke, kind, bf16_math=True)
    assert round(bound, 3) == want_ms


@pytest.mark.parametrize("kind", ["nomap", "nobcast"])
def test_ablation_counts_the_separable_window(kind):
    """nomap's box sum is separable and taken once per (pixel, channel);
    nobcast's tile-constant hat weights take a row and a column pass."""
    smoke = load_smoke()
    H, W, C, Co, R = 24, 80, 256, 128, smoke.R
    n = smoke.BATCH * H * W
    gemm = 2 * 9 * n * C * Co
    window = (4 * R * n * C if kind == "nomap"
              else 4 * (2 * R + 1) * 9 * n * C + 11 * (2 * R + 1) * 9 * n)
    assert smoke.dcn_work(kind, H, W, C, Co, 4)[0] == gemm + window
