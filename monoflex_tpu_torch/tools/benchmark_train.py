"""Training-step throughput of the port on one card, the counterpart of the
JAX package's ``tools/benchmark_train.py``::

    python -m monoflex_tpu_torch.tools.benchmark_train
    BENCH_DTYPE=bfloat16 BENCH_ITERS=50 python -m monoflex_tpu_torch.tools.benchmark_train

One full training step (train-mode forward, the 11 losses, backward, AdamW
with the non-finite guard: ``train/train_step.py::make_train_step`` and
``train/solver.py``) of ``runs/monoflex.yaml`` with seeded weights
(``build_model(seed=0)``), on ``data/synthetic.py::make_train_batch`` at
batch ``BENCH_BATCH`` (8) and 384x1280, moved to the card before timing:
``bench.WARMUP_CALLS`` untimed steps (cuDNN's autotune), then
``BENCH_ITERS`` (10) steps between two ``torch.cuda.synchronize()``.

The last line is the JAX line::

    {"metric": "train_images_per_sec_per_chip", "value": ..., "unit": "img/s",
     "vs_baseline": ...}

``vs_baseline`` is over the JAX package's derived V100-era train baseline,
10.8 img/s (33 img/s inference divided by the train:forward FLOP ratio
3.05; BASELINE.md).  Earlier lines give the card's name and power limit,
the precision flags, the time of one step, the peak device memory of the
timed steps (``max_memory_allocated`` after ``reset_peak_memory_stats``) and
the steps the non-finite guard skipped.

Knobs, as the JAX tool reads them: ``BENCH_DCN_IMPL`` (shift, or none for
``dla34_nodcn``), ``BENCH_REMAT`` (any value: ``TPU.REMAT_BACKBONE``),
``BENCH_KERNEL_VERSION``, ``BENCH_IMPL_PER_STAGE``, ``BENCH_DTYPE``,
``BENCH_INPUT`` ("HxW", the training input), ``BENCH_BATCH``,
``BENCH_ITERS``, ``BENCH_PROFILE=<dir>`` (a torch.profiler trace of the
timed steps, with the device's busy ms and idle share) and
``MONOFLEX_PLATFORM=cpu``, which runs the tool on the CPU.  Without that
and without a card it prints the error line (``"value": null``) and exits 1.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch

from ..bench import (DEFAULT_BATCH, ROOT, WARMUP_CALLS, card_line, require_device,
                     result_line, timed_loop)
from ..config import get_cfg_defaults
from ..data.synthetic import make_train_batch
from ..losses.loss_computation import LossComputer
from ..models.detector import build_model
from ..train.solver import build_optimizer
from ..train.train_step import TrainState, make_train_step
from ..utils.precision import current_precision
from . import write_launch_log

METRIC = "train_images_per_sec_per_chip"
# BASELINE.md: 33 img/s / (545.9 / 178.9 train:forward GFLOP) = 10.8 img/s
TRAIN_BASELINE_IMG_S = 10.8
DEFAULT_ITERS = 10


def train_config(env: Mapping[str, str] = os.environ):
    """``runs/monoflex.yaml`` with the JAX tool's BENCH_* knobs."""
    cfg = get_cfg_defaults()
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


def main(device: Optional[str] = None, env: Mapping[str, str] = os.environ) -> None:
    if device is None:
        device = "cpu" if env.get("MONOFLEX_PLATFORM") == "cpu" else "cuda"
    device = require_device(device, METRIC)
    cfg = train_config(env)
    batch_size = int(env.get("BENCH_BATCH", DEFAULT_BATCH))
    iters = int(env.get("BENCH_ITERS", DEFAULT_ITERS))
    model = build_model(cfg, device=device, seed=0)
    optimizer, _, _ = build_optimizer(cfg, model)
    step = make_train_step(model, LossComputer(cfg), optimizer)
    batch = {k: torch.from_numpy(v).to(device) for k, v in make_train_batch(
        batch_size, input_height=cfg.INPUT.HEIGHT_TRAIN,
        input_width=cfg.INPUT.WIDTH_TRAIN).items()}
    print(card_line(device), flush=True)
    print("precision: " + " ".join(f"{k}={v}" for k, v in current_precision().items())
          + f" compute_dtype={cfg.TPU.COMPUTE_DTYPE}", flush=True)

    state = [TrainState()]
    skipped = [0.0]

    def train():
        state[0], metrics = step(state[0], batch)
        skipped[0] += metrics["skipped"]

    for _ in range(WARMUP_CALLS):
        train()
    skipped[0] = 0.0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    elapsed = timed_loop(train, iters, device, env.get("BENCH_PROFILE"), "benchmark_train")
    peak = (f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB" if device.type == "cuda"
            else "not measured (cpu)")
    print(f"batch {batch_size} at {cfg.INPUT.HEIGHT_TRAIN}x{cfg.INPUT.WIDTH_TRAIN}: "
          f"{elapsed * 1e3 / iters:.3f} ms a step over {iters} steps after {WARMUP_CALLS} "
          f"warm-up steps; peak memory {peak}; skipped steps {skipped[0]:g}", flush=True)
    write_launch_log()
    print(result_line(METRIC, batch_size * iters, elapsed, TRAIN_BASELINE_IMG_S), flush=True)


if __name__ == "__main__":
    main()
