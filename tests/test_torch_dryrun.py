"""The port's counterpart of ``__graft_entry__.py::dryrun_multichip``
(``parallel/dryrun.py``): one full training step over two gloo ranks on the
CPU prints the JAX line with a finite total; without a card the entry point
exits non-zero.  That two ranks compute one process's step is
``tests/test_torch_distributed.py``'s to show; this checks the entry point.
"""

import math
import os
import re
import subprocess
import sys

import pytest
import torch

from monoflex_tpu_torch.parallel.dryrun import dryrun_multichip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_gloo_ranks_take_one_step(capfd):
    total = dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    line = re.search(r"dryrun_multichip\(2\) OK: total_loss=(\S+)", out)
    assert line and math.isfinite(total) and float(line.group(1)) == pytest.approx(total, abs=1e-4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the exit without a card")
def test_exits_without_a_card():
    r = subprocess.run([sys.executable, "-m", "monoflex_tpu_torch.parallel.dryrun", "1"],
                       capture_output=True, text=True, cwd=REPO, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode != 0 and "needs 1 CUDA card" in r.stderr
