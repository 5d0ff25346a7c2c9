"""The readers of the program's own spans and counters (``metrics/_program.py``
and the metrics that use it) on made-up runs; the drain that hands the
main thread's spans, shifted by the clock skew, to the harness's spans; and
each cell on the CPU: a ``--trace 1`` line with the cell's new metrics and
idle gaps under the program's spans, a ``--trace 0`` run that records no
span."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from conftest import ROOT, SMALL
from mfbench.harness import Run, read_metric
from mfbench.metrics import _program
from mfbench.metrics._program import ProgramTrace, clock_skew_s, idle_within
from mfbench.trace import DeviceTrace, Spans

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
PROGRAM_METRICS = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in (
    "step_host_ms.train", "snapshot_ms.train", "optimizer_idle_ms.train",
    "loader_wait_ms.train", "loader_build_ms.train", "upload_gbps.train",
    "forward_enqueue_ms.infer", "forward_enqueue_ms.stream", "decode_host_ms.stream")}


def step_spans(t, snapshot=0.002, forward=0.05, loss=0.01, backward=0.06, sync=0.03,
               optimizer=0.005):
    """One step's main-thread spans from host time t; returns them and its end."""
    out = []
    for name, d in (("train_step.snapshot", snapshot), ("train_step.forward", forward),
                    ("train_step.loss", loss), ("train_step.backward", backward),
                    ("train_step.finite_sync", sync), ("train_step.optimizer", optimizer)):
        out.append((name, t, t + d))
        t += d
    return out, t


def train_run(ops=()):
    run = Run(cell="x", kind="train", batch=8)
    run.trace, run.trace_calls = DeviceTrace(0.0, 1.0, list(ops)), 2
    main, t = [], 0.1
    for _ in range(2):
        main.append(("loader.wait", t, t + 0.001))
        main.append(("to_device", t + 0.001, t + 0.011))
        spans, t = step_spans(t + 0.011)
        main += spans
    main.append(("train_step.forward", 2.0, 2.1))        # after the traced part
    run.__dict__["_program_trace"] = ProgramTrace(
        main=main, other=[("loader.build", 0.0, 0.3), ("loader.put_wait", 0.3, 0.4),
                          ("loader.build", 0.4, 0.6)],
        counters={"to_device.bytes": 40_000_000, "loader.batches": 2}, skew_s=0.0)
    return run


def test_train_readers():
    run = train_run()
    assert read_metric("step_host_ms.train", run) == pytest.approx(2 + 50 + 10 + 60 + 5)
    assert read_metric("snapshot_ms.train", run) == pytest.approx(2.0)
    assert read_metric("loader_wait_ms.train", run) == pytest.approx(1.0)
    assert read_metric("loader_build_ms.train", run) == pytest.approx(250.0)
    assert read_metric("upload_gbps.train", run) == pytest.approx(40e6 / 0.02 / 1e9)
    assert read_metric("optimizer_idle_ms.train", run) is None      # no device ops


def test_optimizer_idle_reads_the_gaps_under_the_optimizer():
    # the first step's optimizer runs 0.263-0.268 on the host; a kernel
    # covers 0.264-0.266 of it; the second step's 0.431-0.436 is all idle
    ops = [("k", 0.0, 0.263), ("k", 0.264, 0.266), ("k", 0.268, 0.431), ("k", 0.436, 1.0)]
    run = train_run(ops)
    assert read_metric("optimizer_idle_ms.train", run) == pytest.approx((0.003 + 0.005) * 1e3 / 2)
    # without a marker the ops are on another clock than the spans: nothing is read
    run = train_run(ops)
    run.__dict__["_program_trace"].skew_s = None
    assert read_metric("optimizer_idle_ms.train", run) is None


def test_infer_readers():
    run = Run(cell="x", kind="infer", batch=1)
    run.trace = DeviceTrace(0.0, 1.0, [])
    run.__dict__["_program_trace"] = ProgramTrace(main=[
        ("to_device", 0.0, 0.001), ("eval_step.forward", 0.001, 0.011),
        ("eval_step.decode", 0.011, 0.017), ("eval_step.forward", 0.05, 0.062),
        ("eval_step.decode", 0.062, 0.066), ("eval_step.forward", 1.5, 1.6)])
    assert read_metric("forward_enqueue_ms.infer", run) == pytest.approx(11.0)
    assert read_metric("forward_enqueue_ms.stream", run) == pytest.approx(11.0)
    assert read_metric("decode_host_ms.stream", run) == pytest.approx(5.0)


def test_no_program_tracer_reads_nothing(monkeypatch):
    monkeypatch.delitem(sys.modules, _program.TRACER_MODULE, raising=False)
    run = Run(cell="x", kind="train", batch=8)
    run.trace = DeviceTrace(0.0, 1.0, [("k", 0.0, 0.5)])
    for name, m in PROGRAM_METRICS.items():
        assert read_metric(name, run) is None, name
    assert run.spans.items == []
    run = Run(cell="x", kind="train", batch=8)            # untraced: not even looked up
    assert _program.program_trace(run) is None


def test_the_drain_moves_the_device_ops_and_hands_over_the_main_spans(monkeypatch):
    from monoflex_tpu_torch.utils.trace import Drained, Span

    drained = Drained(spans=[Span("train_step.snapshot", 0.2001, 0.25, None, "MainThread"),
                             Span("train_step.optimizer", 0.30, 0.31, None, "MainThread"),
                             Span("loader.build", 0.0, 0.2, None, "loader")],
                      counters={"to_device.bytes": 5}, anchor=0.1)
    calls = []
    fake = SimpleNamespace(drain=lambda: calls.append(1) or drained)
    monkeypatch.setitem(sys.modules, _program.TRACER_MODULE, fake)
    run = Run(cell="x", kind="train", batch=8)
    run.spans = Spans()
    run.spans.items.append(("step", 0.2, 0.4))
    # the harness maps the marker 3 ms before its launch on the host clock
    ops = [("k", 0.0, 0.05), ("void spin_kernel(long)", 0.097, 0.098), ("k", 0.19, 0.2),
           ("k", 0.247, 0.997)]
    run.trace = DeviceTrace(0.0, 1.0, list(ops))
    pt = _program.program_trace(run)
    assert pt.skew_s == pytest.approx(-3e-3)
    assert _program.program_trace(run) is pt and calls == [1]      # drained once
    assert pt.other == [("loader.build", 0.0, 0.2)] and pt.counters == {"to_device.bytes": 5}
    assert [t for _, s, e in run.trace.ops for t in (s, e)] == pytest.approx(
        [0.003, 0.053, 0.1, 0.101, 0.193, 0.203, 0.25, 1.0])
    assert ("train_step.optimizer", 0.30, 0.31) in run.spans.items
    assert "loader.build" not in {n for n, _, _ in run.spans.items}
    # the child starts after its parent on one clock: the gap in the
    # snapshot goes to the snapshot
    got = dict(run.trace.idle_by_span(run.spans))
    assert got["train_step.snapshot"] == pytest.approx(0.25 - 0.203)
    assert run.spans.at(0.35) == "step"


@pytest.mark.parametrize("ops", [
    [("k", 0.0, 0.05), ("k", 0.19, 0.2)],         # the profiler dropped the marker
    [],                                            # no device op: nothing to tie
])
def test_the_drain_without_a_marker(monkeypatch, capsys, ops):
    from monoflex_tpu_torch.utils.trace import Drained, Span

    drained = Drained(spans=[Span("train_step.optimizer", 0.30, 0.31, None, "MainThread")],
                      counters={}, anchor=0.1)
    monkeypatch.setitem(sys.modules, _program.TRACER_MODULE,
                        SimpleNamespace(drain=lambda: drained))
    run = Run(cell="x", kind="train", batch=8)
    run.spans.items.append(("step", 0.2, 0.4))
    run.trace = DeviceTrace(0.0, 1.0, list(ops))
    pt = _program.program_trace(run)
    assert run.trace.ops == ops                   # not moved
    if ops:
        assert pt.skew_s is None and "clock_skew_us none" in capsys.readouterr().err
        assert run.spans.items == [("step", 0.2, 0.4)]       # kept out of the breakdown
    else:
        assert pt.skew_s == 0.0 and ("train_step.optimizer", 0.30, 0.31) in run.spans.items


def test_skew_and_gap_arithmetic():
    ops = [("a", 0.0, 1.0), ("spin_kernel", 2.0, 2.1), ("spin_kernel", 5.0, 5.1)]
    assert clock_skew_s(ops, 4.9) == pytest.approx(0.1)
    assert clock_skew_s(ops, None) is None and clock_skew_s(ops[:1], 1.0) is None
    gaps = [(1.0, 2.0), (3.0, 4.0), (6.0, 9.0)]
    assert idle_within(gaps, [("x", 1.5, 3.5), ("y", 8.5, 20.0)]) == pytest.approx(1.5)
    assert idle_within(gaps, [("x", 0.0, 0.5)]) == 0.0


def test_benchmark_lists_each_new_metric_for_its_cells():
    assert len(PROGRAM_METRICS) == 9
    for name, m in PROGRAM_METRICS.items():
        assert os.path.exists(os.path.join(ROOT, "mfbench", "metrics", f"{name}.py"))
        assert set(m["workloads"]) <= set(CELLS)


RUN = """
import sys, json
import torch
torch.set_num_threads(2)
from mfbench.harness import main
main(["--workload", sys.argv[1], "--seed", "2147483011", "--seconds", "1.0",
      "--trace", sys.argv[3]], device="cpu", overrides=json.loads(sys.argv[2]))
from monoflex_tpu_torch.utils import trace
print(json.dumps({"left": len(trace.drain().spans)}))
"""


def run_cell(cell, traced):
    out = subprocess.run([sys.executable, "-c", RUN, cell, json.dumps(SMALL), str(traced)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), out.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_carries_the_program_metrics(cell):
    result, left, err = run_cell(cell, 1)
    want = {n for n, m in PROGRAM_METRICS.items() if cell in m["workloads"]
            and m["source"] == "host_clock"}          # no device on the CPU
    assert want and want <= set(result["metrics"]), sorted(want - set(result["metrics"]))
    assert all(result["metrics"][n]["value"] > 0 for n in want)
    gaps = [name for name, _ in result["breakdown"]["idle_gaps"]]
    prefix = "train_step." if cell.startswith("train") else "eval_step."
    assert any(name.startswith(prefix) for name in gaps), gaps
    assert "program spans" in err and left == {"left": 0}


def test_an_untraced_run_records_no_span():
    result, left, _ = run_cell("train-bf16-step", 0)
    assert "train_img_per_s" in result["metrics"]
    assert left == {"left": 0}
