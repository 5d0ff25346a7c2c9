"""A run with the timed path broken underneath comes out not correct: the
harness drives the rest of a run on the CPU at the narrow size (no look for
a card) with each fault the cell can have planted (``faults.py``), and with
none.  The exchange between chips does not exist in these one-chip cells.
A DCN's dx made 20% larger shows in ``dcn_grad_gap`` alone: the forward is
untouched and AdamW's first updates hardly depend on the gradient's size."""

import pytest
import torch

from conftest import SMALL
from mfbench.harness import main

FAULTS = {
    "train-bf16-step": ["frozen_state", "half_batch", "dcn_dx_scaled"],
    "train-f32-loop": ["frozen_state", "half_batch", "dcn_dx_scaled"],
    "infer-bf16-b8": ["half_batch", "alter_answer"],
    "stream-bf16-b1": ["alter_answer"],
}
CASES = [(cell, fault) for cell, faults in FAULTS.items() for fault in [None] + faults]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_makes_the_run_incorrect(cell, fault):
    torch.set_num_threads(2)
    small = dict(SMALL, batch=1) if cell.startswith("stream") else SMALL
    result = main(["--workload", cell, "--seed", "11", "--seconds", "0.2", "--trace", "0"],
                  device="cpu", overrides=small, faults=[fault] if fault else None)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"


def test_a_wrong_dcn_dx_shows_in_the_dcn_numbers_only():
    torch.set_num_threads(2)
    result = main(["--workload", "train-bf16-step", "--seed", "12", "--seconds", "0.2",
                   "--trace", "0"], device="cpu", overrides=SMALL, faults=["dcn_dx_scaled"])
    checks = result["checks"]
    assert checks["dcn_grad_gap"]["value"] == pytest.approx(0.2, abs=0.01)
    assert all(v["value"] <= v["limit"] for k, v in checks.items() if k != "dcn_grad_gap")
