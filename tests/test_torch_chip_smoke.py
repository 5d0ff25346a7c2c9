"""chip_smoke.py has no CPU fallback: without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""     # hide any card
    return subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


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
