"""The reader of the train step's CUDA graph share
(``metrics/train_graph_share.train``) on made-up runs, and its entry in
``BENCHMARK.json``."""

import json
import os
import sys

import pytest

from conftest import ROOT
from mfbench.harness import Run, read_metric
from mfbench.metrics import _program
from mfbench.metrics._program import ProgramTrace
from mfbench.trace import DeviceTrace

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = "train_graph_share.train"


def train_run(counters, eager_steps=0):
    """Three steps in the traced second, one after it; the first
    ``eager_steps`` of them with an eager step's spans."""
    main = []
    for i, t in enumerate((0.001, 0.2, 0.4, 1.5)):
        main.append(("train_step.forward", t, t + 0.01))
        if i < eager_steps:
            main += [("train_step.loss", t + 0.01, t + 0.02),
                     ("train_step.backward", t + 0.02, t + 0.03),
                     ("train_step.optimizer", t + 0.04, t + 0.05)]
        main.append(("train_step.finite_sync", t + 0.03, t + 0.04))
    run = Run(cell="x", kind="train", batch=8)
    run.trace = DeviceTrace(0.0, 1.0, [])
    run.__dict__["_program_trace"] = ProgramTrace(main=main, counters=counters)
    return run


def test_replays_over_steps():
    assert read_metric(NAME, train_run({"train_step.graph_replays": 3})) == pytest.approx(1.0)
    assert read_metric(NAME, train_run({"train_step.graph_replays": 1,
                                        "train_step.graph_captures": 1},
                                       eager_steps=2)) == pytest.approx(1 / 3)


def test_a_program_without_graphs_reads_nothing(monkeypatch):
    assert read_metric(NAME, train_run({}, eager_steps=3)) is None
    monkeypatch.delitem(sys.modules, _program.TRACER_MODULE, raising=False)
    run = Run(cell="x", kind="train", batch=8)
    run.trace = DeviceTrace(0.0, 1.0, [])
    assert read_metric(NAME, run) is None


def test_no_step_in_the_trace_reads_nothing():
    run = Run(cell="x", kind="train", batch=8)
    run.trace = DeviceTrace(0.0, 1.0, [])
    run.__dict__["_program_trace"] = ProgramTrace(main=[], counters={
        "train_step.graph_replays": 2})
    assert read_metric(NAME, run) is None


def test_benchmark_lists_the_share_for_the_train_cells():
    got = [m for m in BENCH["per_layer"] if m["name"] == NAME]
    assert len(got) == 1
    m = got[0]
    assert m["workloads"] == ["train-f32-loop", "train-bf16-step"]
    assert (m["unit"], m["better"], m["source"]) == ("ratio", "higher", "program_counter")
    assert (m["layer"], m["moves"]) == ("train step", "train_img_per_s")
    assert os.path.exists(os.path.join(ROOT, "mfbench", "metrics", f"{NAME}.py"))
