"""The port's training-step benchmark (``monoflex_tpu_torch/tools/
benchmark_train.py``): its JAX line from a CPU run at a small size, its
knobs against the config keys the JAX tool sets, and its exit without a
card."""

import json
import math
import os
import subprocess
import sys

import pytest

from monoflex_tpu.config import get_cfg_defaults as jax_cfg_defaults
from monoflex_tpu_torch.tools import benchmark_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(env):
    env = {**{k: v for k, v in os.environ.items() if not k.startswith("BENCH_")},
           "OMP_NUM_THREADS": "2", **env}
    return subprocess.run([sys.executable, "-m", "monoflex_tpu_torch.tools.benchmark_train"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


def test_cpu_run_prints_the_jax_line():
    proc = run({"MONOFLEX_PLATFORM": "cpu", "BENCH_INPUT": "64x128", "BENCH_BATCH": "1",
                "BENCH_ITERS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert sorted(last) == ["metric", "unit", "value", "vs_baseline"]
    assert last["metric"] == "train_images_per_sec_per_chip" and last["unit"] == "img/s"
    assert math.isfinite(last["value"]) and last["value"] > 0
    assert abs(last["vs_baseline"] - last["value"] / 10.8) <= 5e-4 + 5e-3 / 10.8
    assert any(ln.startswith("batch 1 at 64x128: ") and "skipped steps 0" in ln for ln in lines)


def test_without_a_card_it_exits_with_the_error_line():
    proc = run({"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["metric"] == "train_images_per_sec_per_chip" and last["value"] is None


def jax_train_cfg(env):
    """``tools/benchmark_train.py``'s config edits, in the JAX config."""
    cfg = jax_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
    impl = env.get("BENCH_DCN_IMPL")
    if impl == "shift":
        cfg.TPU.USE_PALLAS_DCN = False
    elif impl == "none":
        cfg.MODEL.BACKBONE.CONV_BODY = "dla34_nodcn"
    if env.get("BENCH_REMAT"):
        cfg.TPU.REMAT_BACKBONE = True
    if env.get("BENCH_KERNEL_VERSION"):
        cfg.TPU.DCN_KERNEL_VERSION = int(env["BENCH_KERNEL_VERSION"])
    if env.get("BENCH_IMPL_PER_STAGE"):
        cfg.TPU.DCN_IMPL_PER_STAGE = tuple(env["BENCH_IMPL_PER_STAGE"].split(","))
    if env.get("BENCH_DTYPE"):
        cfg.TPU.COMPUTE_DTYPE = env["BENCH_DTYPE"]
    if env.get("BENCH_INPUT"):
        h, w = (int(v) for v in env["BENCH_INPUT"].split("x"))
        cfg.INPUT.HEIGHT_TRAIN = h
        cfg.INPUT.WIDTH_TRAIN = w
    return cfg


KEYS = ("TPU.USE_PALLAS_DCN", "MODEL.BACKBONE.CONV_BODY", "TPU.REMAT_BACKBONE",
        "TPU.DCN_KERNEL_VERSION", "TPU.DCN_IMPL_PER_STAGE", "TPU.COMPUTE_DTYPE",
        "INPUT.HEIGHT_TRAIN", "INPUT.WIDTH_TRAIN")


def key(cfg, name):
    for part in name.split("."):
        cfg = getattr(cfg, part)
    return tuple(cfg) if isinstance(cfg, (list, tuple)) else cfg


@pytest.mark.parametrize("env", [
    {}, {"BENCH_DCN_IMPL": "shift"}, {"BENCH_DCN_IMPL": "none"}, {"BENCH_REMAT": "1"},
    {"BENCH_KERNEL_VERSION": "2"}, {"BENCH_IMPL_PER_STAGE": "pallas2,pallas,pallas,pallas"},
    {"BENCH_DTYPE": "bfloat16"}, {"BENCH_INPUT": "96x320"}], ids=json.dumps)
def test_knobs_set_the_jax_tool_keys(env):
    cfg, jcfg = benchmark_train.train_config(env), jax_train_cfg(env)
    assert {k: key(cfg, k) for k in KEYS} == {k: key(jcfg, k) for k in KEYS}
