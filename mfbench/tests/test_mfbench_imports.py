"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level module names (``monoflex_tpu_torch`` begins with
``monoflex_tpu`` and is allowed), and the reference loads nothing of the
program.  Each cell runs once, on the CPU at the narrow size, in a process
of its own."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, SMALL

BANNED = {"jax", "jaxlib", "flax", "monoflex_tpu"}
CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]

RUN = """
import sys, json
import torch
torch.set_num_threads(2)
from mfbench.harness import main
main(["--workload", sys.argv[1], "--seed", "3", "--seconds", "0.2", "--trace", "1"],
     device="cpu", overrides=json.loads(sys.argv[2]))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    out = subprocess.run([sys.executable, "-c", RUN, cell, json.dumps(SMALL)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    tops = set(json.loads(lines[-1]))
    assert "monoflex_tpu_torch" in tops
    assert not tops & BANNED
    assert json.loads(lines[-2])["device"]["platform"] == "cpu"


def test_the_harness_refuses_a_loaded_jax_package():
    from mfbench.harness import banned_modules

    sys.modules.setdefault("monoflex_tpu_torch_probe", sys)
    assert "monoflex_tpu" not in banned_modules()
    sys.modules["monoflex_tpu"] = sys
    try:
        assert "monoflex_tpu" in banned_modules()
    finally:
        del sys.modules["monoflex_tpu"]
        del sys.modules["monoflex_tpu_torch_probe"]


def test_the_reference_loads_none_of_the_program():
    code = ("import sys, json; import mfbench.reference.model, mfbench.check, mfbench.work; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & (BANNED | {"monoflex_tpu_torch"})
