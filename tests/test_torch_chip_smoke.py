"""chip_smoke.py has no CPU fallback: without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.
Its bounds count the work each kernel's function needs, and its bench phase
reads the benchmark entry points' lines."""

import json
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
    bound counts them at the tensor cores' rate (one pass), the sampling at
    f32; the f32 math takes the kernels' split-bf16 passes."""
    smoke = load_smoke()
    H, W, C, Co = 96, 320, 64, 64
    ops, nbytes, tc = smoke.dcn_work(kind, H, W, C, Co, 4)
    s_ops, s_bytes, s_tc = smoke.dcn_work(kind, H, W, C, Co, 4, bf16_math=True)
    products = (2 if kind == "dwmo" else 1) * 2 * 9 * smoke.BATCH * H * W * C * Co
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
                                             ("dx", 0.646, "operations")])
def test_neck_bounds_count_tensor_core_passes(kind, want_ms, by):
    """dcn_fwd and its epilogue form take their f32-class product as 6
    passes of 3-part split-bf16 operands on the tensor cores (989 TFLOP/s),
    dcn_bwd_dwmo its two products as 3 passes of 2-part operands: 1.29 ms
    each over the neck's 16 layers at batch 8; dcn_bwd_dx its one product
    as 3 passes: 0.646 ms (3.33 ms while it ran f32 FMAs)."""
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
    nobcast's tile-constant hat weights take a row and a column pass; both
    f32.  Their contraction runs on the tensor cores as dcn_fwd's, at its
    six bf16 passes."""
    smoke = load_smoke()
    H, W, C, Co, R = 24, 80, 256, 128, smoke.R
    n = smoke.BATCH * H * W
    gemm = 2 * 9 * n * C * Co
    window = (4 * R * n * C if kind == "nomap"
              else 4 * (2 * R + 1) * 9 * n * C + 11 * (2 * R + 1) * 9 * n)
    f32, _, tc = smoke.dcn_work(kind, H, W, C, Co, 4)
    assert (f32, tc) == (window, smoke.TC_PASSES["fwd"] * gemm)


def test_trainer_phase_reads_a_cpu_run_of_its_cli(tmp_path):
    """The trainer phase's first CLI run (its opts, its process, its launch
    log, its checks of the log and the checkpoints) under
    MONOFLEX_PLATFORM=cpu at 96x320, batch 2, on a 1/4-scale tree; the
    kernels are not launched on the CPU, so the launch log reads 0."""
    from monoflex_tpu_torch.config import get_cfg_defaults
    from monoflex_tpu_torch.data.synthetic import make_synthetic_kitti

    smoke = load_smoke()
    make_synthetic_kitti(str(tmp_path / "kitti" / "training"), scale=4)
    out = tmp_path / "run"
    env = {**os.environ, "MONOFLEX_PLATFORM": "cpu", "MONOFLEX_DATA_DIR": str(tmp_path),
           "OMP_NUM_THREADS": "2", "PYTHONPATH": ROOT}
    small = ["INPUT.HEIGHT_TRAIN", "96", "INPUT.WIDTH_TRAIN", "320", "INPUT.HEIGHT_TEST", "96",
             "INPUT.WIDTH_TEST", "320", "DATALOADER.NUM_WORKERS", "2", "MODEL.HEAD.NUM_CHANNEL", "16"]
    log, launches = smoke.run_cli(
        ["--config", os.path.join(ROOT, "runs", "monoflex_ema.yaml"), "--output", str(out),
         "--profile", "2", *smoke.trainer_opts(smoke.TRAINER_ITERS, batch=2), *small],
        env, str(tmp_path), "train")
    assert launches["dcn_fwd"] == launches["dcn_bwd_dx"] == 0
    meters = smoke.loop_meters(log, smoke.TRAINER_ITERS)
    assert all(v > 0 for v in meters.values())
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex_ema.yaml"))
    rec = smoke.last_terms(str(out), cfg.MODEL.HEAD.LOSS_NAMES)
    assert rec["step"] == smoke.TRAINER_ITERS
    assert sorted(os.listdir(out / "ckpt")) == [
        "last_checkpoint", f"model_checkpoint_{smoke.TRAINER_SAVE}", "model_final",
        "model_final_ema", "model_moderate_best_soft"]
    assert "profiler trace of 2 steps" in log
    assert len(os.listdir(out / f"eval_{smoke.TRAINER_ITERS}" / "data")) == 3
    shutil.rmtree(out)      # its checkpoints take a few hundred MB each


def test_trainer_phase_parses_the_profile_line():
    from monoflex_tpu_torch.engine.trainer import profile_line

    smoke = load_smoke()
    got = smoke.profile_window("x INFO: " + profile_line(5, "/o/profile/t.json", 1500.0, 1200.0))
    assert got == {"steps": 5, "wall_ms": 1500.0, "busy_ms": 1200.0, "idle_share": 0.2}
    assert smoke.profile_window(profile_line(5, "/o/t.json", 1500.0, 0.0)) is None
    with pytest.raises(AssertionError):
        smoke.profile_window(profile_line(5, "/o/t.json", 1500.0, None))


def test_trainer_phase_counts_launches_per_iteration():
    smoke = load_smoke()
    ok = {"dcn_fwd": 16 * 22, "dcn_fwd_bn_relu": 0, "dcn_bwd_dx": 320, "dcn_bwd_dwmo": 320}
    smoke.check_trainer_launches(ok, 20, 2, "train")
    smoke.check_trainer_launches(dict(ok, dcn_fwd=0, dcn_fwd_bn_relu=16 * 22), 20, 2, "fused")
    for bad in (dict(ok, dcn_bwd_dx=319), dict(ok, dcn_fwd=16 * 20)):
        with pytest.raises(AssertionError):
            smoke.check_trainer_launches(bad, 20, 2, "train")


@pytest.mark.parametrize("rate", [3.19, 106.594999, 278.05, 41.0349])
def test_bench_phase_reads_the_entry_points_lines(rate):
    """The bench phase takes the entry points' JAX lines, whatever the
    rounding of value and vs_baseline, and refuses a line that lacks a key,
    carries the error's null value or a wrong vs_baseline."""
    from monoflex_tpu_torch import bench
    from monoflex_tpu_torch.tools.benchmark_train import METRIC, TRAIN_BASELINE_IMG_S

    smoke = load_smoke()
    for metric, baseline in ((bench.METRIC, bench.V100_BASELINE_IMG_PER_S),
                             (METRIC, TRAIN_BASELINE_IMG_S)):
        line = bench.result_line(metric, 8 * 20, 8 * 20 / rate, baseline)
        assert smoke.check_bench_line(line, metric, baseline)["value"] == round(rate, 2)
        rec = json.loads(line)
        for bad in ({k: v for k, v in rec.items() if k != "unit"}, dict(rec, value=None),
                    dict(rec, vs_baseline=rec["vs_baseline"] + 0.01), dict(rec, metric="x")):
            with pytest.raises((AssertionError, TypeError)):
                smoke.check_bench_line(json.dumps(bad), metric, baseline)
        with pytest.raises(AssertionError):
            smoke.check_bench_line(bench.error_line(metric, "no card"), metric, baseline)
