"""The readers of the eval forward's CUDA graph share
(``metrics/eval_graph_share.*``) on made-up runs, and their entries in
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
SHARES = {"eval_graph_share.infer": "infer-bf16-b8", "eval_graph_share.stream": "stream-bf16-b1"}


def infer_run(counters):
    run = Run(cell="x", kind="infer", batch=8)
    run.trace = DeviceTrace(0.0, 1.0, [])
    run.__dict__["_program_trace"] = ProgramTrace(main=[
        ("eval_step.forward", 0.001, 0.002), ("eval_step.decode", 0.002, 0.006),
        ("eval_step.forward", 0.05, 0.051), ("eval_step.decode", 0.051, 0.055),
        ("eval_step.forward", 0.1, 0.101), ("eval_step.decode", 0.101, 0.105),
        ("eval_step.forward", 1.5, 1.501)], counters=counters)       # the last after the trace
    return run


@pytest.mark.parametrize("name", sorted(SHARES))
def test_replays_over_forwards(name):
    assert read_metric(name, infer_run({"eval_step.graph_replays": 3})) == pytest.approx(1.0)
    assert read_metric(name, infer_run({"eval_step.graph_replays": 2,
                                        "eval_step.graph_captures": 1})) == pytest.approx(2 / 3)


@pytest.mark.parametrize("name", sorted(SHARES))
def test_a_program_without_graphs_reads_nothing(name, monkeypatch):
    assert read_metric(name, infer_run({})) is None
    monkeypatch.delitem(sys.modules, _program.TRACER_MODULE, raising=False)
    run = Run(cell="x", kind="infer", batch=8)
    run.trace = DeviceTrace(0.0, 1.0, [])
    assert read_metric(name, run) is None


def test_benchmark_lists_each_share_for_its_cell():
    got = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in SHARES}
    assert sorted(got) == sorted(SHARES)
    for name, m in got.items():
        assert m["workloads"] == [SHARES[name]]
        assert m["layer"] == "forward and decode" and m["source"] == "program_counter"
        assert os.path.exists(os.path.join(ROOT, "mfbench", "metrics", f"{name}.py"))
