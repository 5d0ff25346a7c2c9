"""The control, the reference one precision step below what the
configuration states, comes out not correct: float8 convolutions for the
bf16 configuration (on the CPU too), TF32 for the float32 one (TF32 exists
only on the card: marked ``cuda``).  The readings the limits were set from
were taken on the card at the cells' own sizes (``calibrate.py``,
``PERF.md``)."""

import argparse

import pytest
import torch

from conftest import SMALL
from mfbench.check import verdict
from mfbench.harness import Session, process_start


def control_verdict(cell: str, device: str, overrides):
    args = argparse.Namespace(workload=cell, seed=21, seconds=0.2, trace=0,
                              process_start=process_start())
    session = Session(args, device, overrides)
    try:
        session.measure()
        numbers = session.judge(session.cell.config["control"])
    finally:
        session.close()
    return verdict(numbers, session.cell.limits["limits"])


@pytest.mark.parametrize("cell", ["train-bf16-step", "infer-bf16-b8"])
def test_fp8_control_is_not_correct(cell):
    torch.set_num_threads(2)
    ok, table = control_verdict(cell, "cpu", SMALL)
    assert not ok, table


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["train-f32-loop"])
def test_tf32_control_is_not_correct(cell, card):
    ok, table = control_verdict(cell, card, dict(SMALL, batch=8, height=384, width=1280,
                                                  frames=24, frame_size=[1242, 375]))
    assert not ok, table
