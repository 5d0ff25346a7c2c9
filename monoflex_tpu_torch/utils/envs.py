"""Seeding + environment info (counterpart of ``monoflex_tpu/utils/envs.py``;
reference: utils/envs.py:10-32, engine/defaults.py:71-83)."""

from __future__ import annotations

import datetime
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import torch


def seed_all_rng(seed: int | None = None) -> int:
    """Seed python, numpy and torch; returns the seed (a fresh one from the
    pid, the clock and the OS when ``seed`` is None or negative)."""
    if seed is None or seed < 0:
        seed = (os.getpid()
                + int(datetime.datetime.now().strftime("%S%f"))
                + int.from_bytes(os.urandom(2), "big"))
    np.random.seed(seed % (2 ** 31))
    random.seed(seed)
    torch.manual_seed(seed)
    return seed


def card_info() -> str:
    """``nvidia-smi``'s name and power limit of each card, or why there is
    none to report."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "no nvidia-smi"
    try:
        proc = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return proc.stdout.strip().replace("\n", "; ") or f"nvidia-smi exited {proc.returncode}"


def collect_env_info() -> str:
    cuda = torch.cuda.is_available()
    lines = [
        f"python: {sys.version.replace(os.linesep, ' ')}",
        f"torch: {torch.__version__}",
        f"cuda build: {torch.version.cuda}",
        f"cuda devices: {torch.cuda.device_count() if cuda else 0}"
        + (f" ({torch.cuda.get_device_name(0)})" if cuda else ""),
        f"cards (nvidia-smi name, power limit): {card_info()}",
        f"numpy: {np.__version__}",
    ]
    return "\n".join(lines)
