"""The FCOS3D cell (``infer-fcos3d-bf16-b6``) on the CPU at the narrow size:
a sound run is correct, and the float8 control and each planted fault are
not; its inputs repeat from the seed; its reference loads nothing of the
program.  The limits were set on the card at the cell's own size
(``calibrate.py``, ``PERF.md``)."""

import argparse
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, SMALL
from mfbench.check import verdict
from mfbench.harness import Session, main, process_start

CELL = "infer-fcos3d-bf16-b6"


@pytest.mark.parametrize("fault", [None, "half_batch", "alter_answer"])
def test_a_fault_makes_the_run_incorrect(fault):
    torch.set_num_threads(2)
    result = main(["--workload", CELL, "--seed", "11", "--seconds", "0.2", "--trace", "0"],
                  device="cpu", overrides=SMALL, faults=[fault] if fault else None)
    assert result["correct"] is (fault is None), result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= SMALL["batch"]


def test_fp8_control_is_not_correct():
    torch.set_num_threads(2)
    args = argparse.Namespace(workload=CELL, seed=21, seconds=0.2, trace=0,
                              process_start=process_start())
    session = Session(args, "cpu", SMALL)
    try:
        session.measure()
        ok, table = verdict(session.judge(session.cell.config["control"]),
                            session.cell.limits["limits"])
    finally:
        session.close()
    assert not ok, table


def test_samples_repeat_from_the_seed():
    from mfbench.sources.camera_rig_batches import samples
    from mfbench.spec import data_file, load_json

    cams = load_json(data_file("traffic", "camera_rig"))["cameras"]
    a, b = samples(2 ** 31 + 17, 2, cams[:2], 90, 160), samples(2 ** 31 + 17, 1, cams[:2], 90, 160)
    c = samples(2 ** 31 + 18, 1, cams[:2], 90, 160)
    assert np.array_equal(a[0]["image"], b[0]["image"])
    assert not np.array_equal(a[0]["image"], c[0]["image"])
    assert not np.array_equal(a[0]["image"], a[1]["image"])
    assert a[0]["image"].shape == (2, 90, 160, 3) and a[0]["image"].dtype == np.uint8
    assert a[0]["cam_intrinsic"].shape == (2, 3, 3)


def test_the_reference_loads_none_of_the_program():
    code = ("import sys, json; import mfbench.reference_fcos3d.model; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "monoflex_tpu", "monoflex_tpu_torch"}


def _program_run(counters):
    """A made-up traced run of three calls whose forward and decode spans
    the program wrote, and a fourth after the trace."""
    from mfbench.harness import Run
    from mfbench.metrics._program import ProgramTrace
    from mfbench.trace import DeviceTrace

    run = Run(cell="x", kind="infer", batch=6)
    run.trace = DeviceTrace(0.0, 1.0, [])
    run.__dict__["_program_trace"] = ProgramTrace(main=[
        ("eval_step.forward", 0.001, 0.003), ("eval_step.decode", 0.003, 0.023),
        ("eval_step.forward", 0.1, 0.102), ("eval_step.decode", 0.102, 0.122),
        ("eval_step.forward", 0.2, 0.202), ("eval_step.decode", 0.202, 0.222),
        ("eval_step.forward", 1.5, 1.6)], counters=counters)
    return run


@pytest.mark.parametrize("name", ["eval_graph_share.fcos3d", "eval_graph_share.kitti"])
def test_graph_share_readers(name):
    from mfbench.harness import read_metric

    assert read_metric(name, _program_run({"eval_step.graph_replays": 3})) == pytest.approx(1.0)
    assert read_metric(name, _program_run({"eval_step.graph_replays": 2})) == pytest.approx(2 / 3)
    assert read_metric(name, _program_run({})) is None     # a program without graphs


@pytest.mark.parametrize("name, want", [("forward_enqueue_ms.fcos3d", 2.0),
                                        ("decode_host_ms.fcos3d", 20.0)])
def test_span_readers(name, want):
    from mfbench.harness import read_metric

    assert read_metric(name, _program_run({})) == pytest.approx(want)


def test_the_new_readers_are_listed_for_their_cells():
    bench = json.load(open(f"{ROOT}/BENCHMARK.json"))
    cells = {m["name"]: m["workloads"] for m in bench["per_layer"]}
    for name in ("eval_graph_share.fcos3d", "forward_enqueue_ms.fcos3d", "decode_host_ms.fcos3d",
                 "dcn_fwd_roofline.fcos3d", "mfu.fcos3d", "device_idle_pct.fcos3d",
                 "nms_ms.fcos3d"):
        assert cells[name] == [CELL], name
    assert cells["eval_graph_share.kitti"] == ["stream-kitti-b1"]
