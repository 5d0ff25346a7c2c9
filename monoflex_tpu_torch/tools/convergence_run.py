"""Synthetic 3D convergence gate on the card: train on a rendered cuboid
world and track AP (counterpart of the JAX package's
``tools/convergence_run.py``, with its flags).

  1. build a rendered synthetic-KITTI set (shaded 3D cuboids: class color,
     depth shading, heading-face asymmetry, corner keypoints;
     ``data/synthetic.py::make_synthetic_kitti(render=True)``),
  2. train ``runs/monoflex.yaml`` at 96x320 with periodic eval through the
     port's CLI, as a process,
  3. tabulate ``tensorboard/scalars.jsonl`` as moderate AP against iteration.

Usage::

    python -m monoflex_tpu_torch.tools.convergence_run --iters 3200   # on the card
    python -m monoflex_tpu_torch.tools.convergence_run --frames 443 --iters 9600 \\
        --eval-interval 800 SOLVER.DECAY_EPOCH_STEPS "[60, 75]"
    python -m monoflex_tpu_torch.tools.convergence_run --platform cpu --iters 2
    python -m monoflex_tpu_torch.tools.convergence_run --table-only --output DIR

The default platform is the card; without one the tool exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TABLE_COLS = ("Car_image/moderate", "Car_aos/moderate", "Car_bev_0.50/moderate",
              "Car_3d_0.50/moderate", "Car_bev_0.70/moderate", "Car_3d_0.70/moderate")


def build_dataset(root: str, frames: int, seed: int, scale: int) -> None:
    from ..data.synthetic import make_synthetic_kitti

    marker = os.path.join(root, "kitti", "training", "ImageSets", "train.txt")
    if os.path.exists(marker):
        return
    make_synthetic_kitti(os.path.join(root, "kitti", "training"), seed=seed, scale=scale,
                         n_random_frames=frames, render=True)


def print_table(output: str) -> None:
    path = os.path.join(output, "tensorboard", "scalars.jsonl")
    if not os.path.exists(path):
        print(f"no scalars at {path}")
        return
    rows, keys = {}, set()
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            ev = {k.replace("eval/", ""): v for k, v in rec.items() if k.startswith("eval/Car_")}
            if ev:
                rows.setdefault(rec["step"], {}).update(ev)
                keys.update(ev)
    # the moderate-difficulty trend of the headline metrics (eval/ap.py's
    # names: {cls}_image = 2D bbox, _3d_{iou}, _bev_{iou}, _aos)
    cols = [k for k in TABLE_COLS if k in keys]
    if not cols:
        cols = sorted(k for k in keys if "/moderate" in k)[:6]
    print("| iter | " + " | ".join(c.replace("Car_", "") for c in cols) + " |")
    print("|" + "---|" * (len(cols) + 1))
    for step in sorted(rows):
        vals = [f"{rows[step].get(c, float('nan')):.2f}" for c in cols]
        print(f"| {step} | " + " | ".join(vals) + " |")


def train_command(args) -> list:
    """The CLI process of the gate: the JAX tool's recipe at 96x320."""
    cmd = [
        sys.executable, "-m", "monoflex_tpu_torch.cli",
        "--config", os.path.join(REPO, "runs", "monoflex.yaml"),
        "--output", args.output,
        "INPUT.HEIGHT_TRAIN", "96", "INPUT.WIDTH_TRAIN", "320",
        "INPUT.HEIGHT_TEST", "96", "INPUT.WIDTH_TEST", "320",
        "SOLVER.IMS_PER_BATCH", str(args.batch),
        "SOLVER.MAX_ITERATION", str(args.iters),
        "SOLVER.EVAL_AND_SAVE_EPOCH", "False",
        "SOLVER.EVAL_INTERVAL", str(args.eval_interval),
        "SOLVER.SAVE_CHECKPOINT_INTERVAL", str(args.eval_interval),
        "TEST.IMS_PER_BATCH", "4",
        "DATALOADER.NUM_WORKERS", "2",
        "DATALOADER.CACHE_DATASET", "True",
        "SEED", str(args.seed),
    ]
    if args.impl:
        cmd += ["TPU.DCN_FORCE_IMPL", args.impl]
    return cmd + list(args.overrides)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(REPO, "output", "conv_data"))
    ap.add_argument("--output", default=os.path.join(REPO, "output", "conv_run"))
    ap.add_argument("--platform", default="gpu", choices=["cpu", "gpu"])
    ap.add_argument("--impl", default="",
                    help="TPU.DCN_FORCE_IMPL override (e.g. pallas3, gather)")
    ap.add_argument("--iters", type=int, default=3200)
    ap.add_argument("--eval-interval", type=int, default=400)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--frames", type=int, default=110,
                    help="random rendered frames (the last fifth become val)")
    ap.add_argument("--table-only", action="store_true")
    ap.add_argument("overrides", nargs="*", help="extra cfg KEY VALUE pairs")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.table_only:
        print_table(args.output)
        return

    env = dict(os.environ)
    if args.platform == "cpu":
        env["MONOFLEX_PLATFORM"] = "cpu"
    else:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("convergence_run: no CUDA device (--platform cpu runs on the CPU)")
        env.pop("MONOFLEX_PLATFORM", None)

    build_dataset(args.root, args.frames, args.seed, args.scale)
    env["MONOFLEX_DATA_DIR"] = args.root
    cmd = train_command(args)
    print(" ".join(cmd), flush=True)
    rc = subprocess.call(cmd, env=env, cwd=REPO)
    print_table(args.output)
    sys.exit(rc)


if __name__ == "__main__":
    main()
