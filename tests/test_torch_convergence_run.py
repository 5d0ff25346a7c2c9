"""The port's convergence gate (``tools/convergence_run.py``) against the JAX
tool: the same AP table from the same ``scalars.jsonl`` (exactly: both format
the same floats), the exit without a card, and one 2-iteration CPU run end
to end (a rendered 10-frame set, 16-wide heads).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from monoflex_tpu_torch.tools import convergence_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import convergence_run as jax_convergence_run  # noqa: E402  (the JAX tool)

sys.path.pop(0)


def printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def write_scalars(out_dir, records):
    os.makedirs(out_dir / "tensorboard")
    with open(out_dir / "tensorboard" / "scalars.jsonl", "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


@pytest.mark.parametrize("keys", ["headline", "other"])
def test_table_equals_the_jax_tools(tmp_path, keys):
    cols = (["Car_image/moderate", "Car_aos/moderate", "Car_bev_0.50/moderate",
             "Car_3d_0.50/moderate", "Car_bev_0.70/moderate", "Car_3d_0.70/moderate"]
            if keys == "headline" else ["Car_3d_0.30/moderate", "Car_image/easy"])
    records = [{"step": 10, "loss/total": 3.0}]
    for step in (800, 1600, 2400):
        records.append({"step": step, "time": 0.1})
        records.append({"step": step, **{f"eval/{c}": step / 100 + i for i, c in enumerate(cols)},
                        "eval/Pedestrian_3d_0.50/moderate": 1.0})
    write_scalars(tmp_path, records)
    ours = printed(convergence_run.print_table, str(tmp_path))
    assert ours == printed(jax_convergence_run.print_table, str(tmp_path))
    assert ours.count("\n") == 5 and "| 2400 |" in ours
    assert printed(convergence_run.print_table, str(tmp_path / "none")) == printed(
        jax_convergence_run.print_table, str(tmp_path / "none"))


def test_the_recipe_is_the_jax_tools():
    args = convergence_run.parse_args(["--iters", "9600", "--eval-interval", "800",
                                       "--output", "/x", "SOLVER.DECAY_EPOCH_STEPS", "[60, 75]"])
    cmd = convergence_run.train_command(args)
    assert cmd[1:3] == ["-m", "monoflex_tpu_torch.cli"]
    flat = " ".join(cmd[3:])
    for pair in ("INPUT.HEIGHT_TRAIN 96", "INPUT.WIDTH_TRAIN 320", "SOLVER.IMS_PER_BATCH 4",
                 "SOLVER.MAX_ITERATION 9600", "SOLVER.EVAL_INTERVAL 800", "TEST.IMS_PER_BATCH 4",
                 "DATALOADER.CACHE_DATASET True", "SEED 7", "SOLVER.DECAY_EPOCH_STEPS [60, 75]"):
        assert pair in flat, pair
    assert (args.platform, args.frames, args.scale, args.batch) == ("gpu", 110, 4, 4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the exit without a card")
def test_exits_without_a_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "MONOFLEX_PLATFORM"}
    r = subprocess.run([sys.executable, "-m", "monoflex_tpu_torch.tools.convergence_run",
                        "--root", str(tmp_path / "data"), "--output", str(tmp_path / "run")],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env={**env, "PYTHONPATH": REPO})
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not (tmp_path / "data").exists()


def test_two_cpu_iterations_give_a_table(tmp_path):
    r = subprocess.run([sys.executable, "-m", "monoflex_tpu_torch.tools.convergence_run",
                        "--platform", "cpu", "--iters", "2", "--eval-interval", "2",
                        "--frames", "10", "--root", str(tmp_path / "data"),
                        "--output", str(tmp_path / "run"), "MODEL.HEAD.NUM_CHANNEL", "16"],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "| iter | image/moderate |" in r.stdout and "\n| 2 |" in r.stdout
    assert os.path.exists(tmp_path / "data" / "kitti" / "training" / "ImageSets" / "val.txt")
