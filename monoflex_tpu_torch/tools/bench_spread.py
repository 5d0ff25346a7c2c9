"""The spread of the benchmark entry points over separate processes on the
card::

    python -m monoflex_tpu_torch.tools.bench_spread [--runs 5]

Each configuration is one entry point at its defaults with the environment
below; each run is its own process (``python -m ...``: model build, cuDNN's
autotune and warm-up included, as a user's run has them).  The runs go
round-robin over the configurations (round 1 of each, then round 2, ...), so
that a slow drift of the card or the host falls on all of them.  Prints the
card's name and power limit (nvidia-smi), one JSON line per run (its last
line's value and the peak memory or latency line before it), and one
summary line per configuration: the values, their median, minimum and
maximum, and the spread (max - min) / median.  Exits non-zero without a
card or when a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

from ..bench import ROOT, card_line
from . import require_cuda

CONFIGS = {
    "bench_f32": ("monoflex_tpu_torch.bench", {}),
    "bench_bf16": ("monoflex_tpu_torch.bench", {"BENCH_DTYPE": "bfloat16"}),
    "train_f32_10": ("monoflex_tpu_torch.tools.benchmark_train", {"BENCH_ITERS": "10"}),
    "train_f32_50": ("monoflex_tpu_torch.tools.benchmark_train", {"BENCH_ITERS": "50"}),
    "train_bf16_10": ("monoflex_tpu_torch.tools.benchmark_train",
                      {"BENCH_DTYPE": "bfloat16", "BENCH_ITERS": "10"}),
    "train_bf16_50": ("monoflex_tpu_torch.tools.benchmark_train",
                      {"BENCH_DTYPE": "bfloat16", "BENCH_ITERS": "50"}),
}


def run_once(module: str, extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.pop("MONOFLEX_PLATFORM", None)
    proc = subprocess.run([sys.executable, "-m", module], cwd=ROOT, env={**env, **extra},
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{module} {extra} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                         f"{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    return {"last": json.loads(lines[-1]), "detail": lines[-2]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    require_cuda("bench_spread")
    print(card_line(torch.device("cuda")), flush=True)
    values = {name: [] for name in CONFIGS}
    for r in range(args.runs):
        for name, (module, extra) in CONFIGS.items():
            rec = run_once(module, extra)
            values[name].append(rec["last"]["value"])
            print(json.dumps({"config": name, "run": r + 1, **rec}), flush=True)
    for name, vals in values.items():
        med = statistics.median(vals)
        print(json.dumps({"config": name, "values": vals, "median": med, "min": min(vals),
                          "max": max(vals), "spread": (max(vals) - min(vals)) / med}),
              flush=True)


if __name__ == "__main__":
    main()
