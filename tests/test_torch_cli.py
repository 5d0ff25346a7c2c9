"""The port's command line (``python -m monoflex_tpu_torch.cli``), mirroring
``tests/test_cli.py``: help, clean errors, the card requirement, then CPU
drives under ``MONOFLEX_PLATFORM=cpu`` on a 1/4-scale synthetic KITTI tree
at 96x320: train, ``--eval`` from the final checkpoint, a resume, ``--eval
--vis``, and the same over two processes (gloo; ``--num_chips 2`` to train, then the
``--num_processes``/``--process_id``/``--coordinator_address`` flags to
resume, as ``tests/test_multiprocess.py`` drives the JAX CLI).  The DCN
offset guard's CLI runs are in ``tests/test_torch_cli_guard.py``.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import pytest
import torch

from monoflex_tpu_torch.data.synthetic import make_synthetic_kitti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = [
    "SEED", "1",
    # 16-wide heads: the 256-wide ones take most of a CPU step at this size
    "MODEL.HEAD.NUM_CHANNEL", "16",
    # >= the scale-4 tree's 310x93 images: the pipeline pads, never shrinks
    "INPUT.HEIGHT_TRAIN", "96", "INPUT.WIDTH_TRAIN", "320",
    "INPUT.HEIGHT_TEST", "96", "INPUT.WIDTH_TEST", "320",
    "SOLVER.EVAL_AND_SAVE_EPOCH", "False",
    "SOLVER.SAVE_CHECKPOINT_INTERVAL", "2",
    "TEST.IMS_PER_BATCH", "2",
    "DATALOADER.NUM_WORKERS", "2",
]


def cli_env(cpu=True, **extra):
    env = {k: v for k, v in os.environ.items() if k != "MONOFLEX_PLATFORM"}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=REPO, **extra)
    if cpu:
        env["MONOFLEX_PLATFORM"] = "cpu"
    return env


def run_cli(*args, cpu=True, timeout=300, **env):
    return subprocess.run([sys.executable, "-m", "monoflex_tpu_torch.cli", *args],
                          capture_output=True, text=True, env=cli_env(cpu, **env),
                          cwd=REPO, timeout=timeout)


def free_address():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    make_synthetic_kitti(str(root / "kitti" / "training"), scale=4)
    return root


def test_help():
    r = run_cli("--help", timeout=120)
    assert r.returncode == 0
    for flag in ["--config", "--eval", "--eval_all_depths", "--test", "--ckpt", "--batch_size",
                 "--num_work", "--output", "--vis", "--num_chips", "--profile",
                 "--num_processes", "--process_id", "--coordinator_address"]:
        assert flag in r.stdout, flag


def test_unknown_config_key_clean_error(tmp_path):
    r = run_cli("--config", "runs/monoflex.yaml", "--output", str(tmp_path), "NO.SUCH.KEY", "1",
                timeout=120)
    assert r.returncode != 0
    assert "Unknown config key: NO.SUCH.KEY" in (r.stderr + r.stdout)


def test_missing_dataset_clean_error(tmp_path):
    r = run_cli("--config", "runs/monoflex.yaml", "--output", str(tmp_path), timeout=120,
                MONOFLEX_DATA_DIR=str(tmp_path / "definitely_missing"))
    assert r.returncode != 0
    assert "ImageSets file not found" in (r.stderr + r.stdout)


def test_no_card_exits_without_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would train on it")
    r = run_cli("--config", "runs/monoflex.yaml", "--output", str(tmp_path), cpu=False,
                timeout=120)
    assert r.returncode != 0
    assert "CUDA card" in (r.stderr + r.stdout)
    assert not os.path.exists(tmp_path / "ckpt")


@pytest.fixture
def out(tmp_path):
    """The run's output directory, removed after the test: its checkpoints
    take a few hundred MB each."""
    yield tmp_path / "run"
    shutil.rmtree(tmp_path / "run", ignore_errors=True)


def scalars(out_dir):
    with open(os.path.join(out_dir, "tensorboard", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_eval_resume(data_dir, out):
    env = {"MONOFLEX_DATA_DIR": str(data_dir)}
    r = run_cli("--config", "runs/monoflex_ema.yaml", "--output", str(out), *OPTS,
                "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITERATION", "3",
                "SOLVER.EVAL_INTERVAL", "3", **env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "iter 3/3" in r.stdout
    ckpt = out / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["last_checkpoint", "model_checkpoint_2", "model_final",
                                        "model_final_ema", "model_moderate_best_soft"]
    record = [s for s in scalars(out) if "train/total_loss" in s][-1]
    assert record["step"] == 3 and record["train/skipped"] == 0.0
    assert len(os.listdir(out / "eval_3" / "data")) == 3
    assert os.path.isfile(out / "backup" / "cli.py")
    assert os.path.isfile(out / "backup" / "csrc" / "dcn_fwd.cu")

    r = run_cli("--config", "runs/monoflex_ema.yaml", "--output", str(out), "--eval",
                "--ckpt", str(ckpt / "model_final"), *OPTS, **env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert sorted(os.listdir(out / "inference" / "data")) == [
        "000000.txt", "000001.txt", "000002.txt"]
    assert "metric = R40" in r.stdout and "Car AP@0.70" in r.stdout

    r = run_cli("--config", "runs/monoflex_ema.yaml", "--output", str(out), *OPTS,
                "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITERATION", "4",
                "SOLVER.EVAL_INTERVAL", "100", **env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "resumed from iteration 3" in r.stdout
    assert "optimizer count 3 after the restore" in r.stdout
    assert "iter 4/4" in r.stdout and "iter 1/" not in r.stdout
    assert scalars(out)[-1]["step"] == 4


def test_vis_is_not_served(data_dir, tmp_path):
    """(Named when --vis raised.)  ``--eval --vis`` draws each evaluated
    image's detections into <output>/inference/vis/<id>.png and exits 0."""
    r = run_cli("--config", "runs/monoflex.yaml", "--output", str(tmp_path), "--eval", "--vis",
                *OPTS, MONOFLEX_DATA_DIR=str(data_dir))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    vis = tmp_path / "inference" / "vis"
    assert sorted(os.listdir(vis)) == ["000000.png", "000001.png", "000002.png"]
    assert "wrote 3 visualization images" in r.stdout + r.stderr


def two_process_cli(out, data_dir, max_iter, flags):
    """The CLI under MONOFLEX_PLATFORM=cpu, one Popen for each list of
    process flags in ``flags``; their outputs."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "monoflex_tpu_torch.cli", "--config", "runs/monoflex_ema.yaml",
         "--output", str(out), *f, *OPTS, "SOLVER.IMS_PER_BATCH", "4",
         "SOLVER.EVAL_INTERVAL", "2", "SOLVER.MAX_ITERATION", str(max_iter)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=cli_env(MONOFLEX_DATA_DIR=str(data_dir))) for f in flags]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{o[-4000:]}"
    return outs


def test_two_process_train_eval_resume(data_dir, out):
    """``--num_chips 2`` spawns two gloo ranks: 2 iterations at a global
    batch of 4, an eval at iteration 2 whose result reaches every rank
    before the best save, rank-gated logs.  Then two processes joined by
    the process flags resume from iteration 2."""
    (log,) = two_process_cli(out, data_dir, 2, [["--num_chips", "2"]])
    ckpt = out / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["last_checkpoint", "model_final", "model_final_ema",
                                        "model_moderate_best_soft"]
    assert log.count("iter 2/2") == 1            # rank 1's logger is silent
    assert len(os.listdir(out / "eval_2" / "data")) == 3
    assert len([s for s in scalars(out) if "train/total_loss" in s]) == 1

    address = free_address()
    logs = two_process_cli(out, data_dir, 3, [
        ["--num_processes", "2", "--process_id", str(i), "--coordinator_address", address]
        for i in range(2)])
    assert "resumed from iteration 2" in logs[0]
    assert "iter 3/3" in logs[0] and "iter 3/3" not in logs[1]
    assert scalars(out)[-1]["step"] == 3
