"""The port's tracer (``utils/trace.py``) and its spans at the layer
boundaries: nesting and parents, a stack per thread, nothing recorded and
no clock read while off, counters (and those summed on the device),
``drain()``, recording while
torch.profiler records; the order of a CPU train step's spans (``restore``
only on a non-finite step), the eval step's two spans, the loader's spans
from its producer thread, ``to_device``'s bytes, and the trainer's meters
and profiled chrome trace."""

import json
import logging
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

from monoflex_tpu_torch.utils import trace


@pytest.fixture
def tracer():
    """The process's tracer, drained before and after the test."""
    trace.off()
    trace.drain()
    yield trace
    trace.off()
    trace.drain()


def names(drained, thread="MainThread"):
    return [s.name for s in drained.spans if s.thread == thread]


def test_nesting_and_parents():
    t = trace.Tracer()
    t.on()
    with t.span("outer"):
        with t.span("inner"):
            pass
        with t.span("inner2"):
            pass
    got = t.drain()
    assert [(s.name, s.parent) for s in got.spans] == [
        ("inner", "outer"), ("inner2", "outer"), ("outer", None)]
    inner, inner2, outer = got.spans
    assert outer.start <= inner.start <= inner.end <= inner2.start <= inner2.end <= outer.end
    assert {s.thread for s in got.spans} == {threading.current_thread().name}
    assert got.anchor is None          # no CUDA context: no marker


def test_each_thread_has_its_own_stack():
    t = trace.Tracer()
    t.on()
    done = threading.Event()

    def worker():
        with t.span("worker"):
            with t.span("worker.inner"):
                pass
        done.set()

    with t.span("main"):
        th = threading.Thread(target=worker, name="second")
        th.start()
        th.join(timeout=10)
        with t.span("main.inner"):
            pass
    assert not th.is_alive() and done.is_set()
    got = {s.name: s for s in t.drain().spans}
    assert got["worker"].parent is None and got["worker"].thread == "second"
    assert got["worker.inner"].parent == "worker"
    assert got["main.inner"].parent == "main"
    assert got["main"].thread == threading.current_thread().name


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    class NoClock:
        @staticmethod
        def perf_counter():
            raise AssertionError("clock read while off")

    monkeypatch.setattr(trace, "time", NoClock)
    t = trace.Tracer()
    assert t.span("a") is t.span("b")        # one shared context, nothing allocated
    with t.span("a"):
        with t.span("b"):
            pass
    t.add("c", 5)
    assert not t.recording()
    got = t.drain()
    assert got.spans == [] and got.counters == {}


def test_counters_add_up_across_threads():
    t = trace.Tracer()
    t.on()
    n_threads, n_adds = 4 * (os.cpu_count() or 2), 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [t.add("c", 2) for _ in range(n_adds)])
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    t.add("d")
    got = t.drain()
    assert got.counters == {"c": 2 * n_threads * n_adds, "d": 1}


def test_device_counters_sum_until_drain():
    t = trace.Tracer()
    t.add_on_device("used", torch.tensor([1], dtype=torch.int32))      # off: not counted
    t.on()
    t.add("used", 2)
    for flag in (1, 0, 1):
        t.add_on_device("used", torch.tensor([flag], dtype=torch.int32))
    t.add_on_device("pairs", torch.tensor([True, True, False]))
    assert t.counters == {"used": 2} and set(t.device_counters) == {"used", "pairs"}
    assert t.drain().counters == {"used": 4, "pairs": 2}
    assert t.drain().counters == {} and t.device_counters == {}


def test_drain_returns_and_clears():
    t = trace.Tracer()
    t.on()
    with t.span("a"):
        pass
    t.add("n", 3)
    first = t.drain()
    assert [s.name for s in first.spans] == ["a"] and first.counters == {"n": 3}
    assert isinstance(first.spans[0], trace.Span)
    second = t.drain()
    assert second.spans == [] and second.counters == {}
    t.off()
    with t.span("b"):
        pass
    assert t.drain().spans == []


def test_records_while_the_profiler_records(tracer):
    from torch.profiler import ProfilerActivity, profile

    with tracer.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracer.recording()
        with tracer.span("during"):
            pass
        tracer.add("n")
    with tracer.span("after"):
        pass
    got = tracer.drain()
    assert names(got) == ["during"] and got.counters == {"n": 1}


def test_idle_by_span_and_marker():
    ops = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)]
    spans = [("step", 0.0, 10.0), ("step.opt", 3.0, 4.5), ("step.sync", 4.5, 5.2)]
    got = trace.idle_by_span(ops, spans, 0.0, 7.0)
    # gaps (0, 1) -> step, (3, 5) midpoint 4 -> step.opt, (6, 7) -> step
    assert got == pytest.approx({"step": 2.0, "step.opt": 2.0})
    assert trace.idle_by_span([], [], 0.0, 1.0) == {"other": 1.0}
    ops = [("k", 1.0, 1.1), ("void spin_kernel(long)", 2.00005, 2.0001),
           ("at::spin_kernel", 9.0, 9.1)]
    assert trace.marker_start(ops, 2.0) == pytest.approx(2.00005)
    assert trace.marker_start(ops, None) is None
    assert trace.marker_start(ops[:1], 2.0) is None
    from monoflex_tpu_torch.engine.trainer import idle_line

    assert idle_line({"a": 1.0, "b": 3.0}, 10.0) == (
        "device idle share by host span: b 0.3000, a 0.1000")


# ---------------------------------------------------------------------------
# the spans at the port's layer boundaries


class TinyModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 2, 3, padding=1)
        self.bn = nn.BatchNorm2d(2)

    def forward(self, image, edge_indices=None, edge_len=None):
        return self.bn(self.conv(image))


class TinyLoss:
    """One loss term; not finite where the batch says so."""

    def __call__(self, outputs, batch):
        loss = outputs.square().mean()
        if bool(batch["poison"]):
            loss = loss * float("nan")
        return {"a": loss}, {"a": loss.detach()}


def tiny_step():
    from monoflex_tpu_torch.config import get_cfg_defaults
    from monoflex_tpu_torch.train.solver import build_optimizer
    from monoflex_tpu_torch.train.train_step import make_train_step

    torch.manual_seed(0)
    model = TinyModel()
    optimizer, schedule, _ = build_optimizer(get_cfg_defaults(), model)
    return model, make_train_step(model, TinyLoss(), optimizer), optimizer, schedule


def tiny_batch(poison=False):
    return {"image": torch.randn(2, 3, 8, 8), "poison": torch.tensor(poison)}


def test_train_step_spans_in_order(tracer):
    from monoflex_tpu_torch.train.train_step import TrainState

    model, step, _, _ = tiny_step()
    state = TrainState()
    state, _ = step(state, tiny_batch())          # off: nothing recorded
    assert tracer.drain().spans == []
    tracer.on()
    state, metrics = step(state, tiny_batch())
    assert metrics["skipped"] == 0.0
    got = tracer.drain()
    assert names(got) == ["train_step.snapshot", "train_step.forward", "train_step.loss",
                          "train_step.backward", "train_step.finite_sync",
                          "train_step.optimizer"]
    assert all(s.parent is None for s in got.spans)
    ends = [(s.start, s.end) for s in got.spans]
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))     # one after another
    running_mean = model.bn.running_mean.clone()
    state, metrics = step(state, tiny_batch(poison=True))
    assert metrics["skipped"] == 1.0
    assert names(tracer.drain())[-2:] == ["train_step.finite_sync", "train_step.restore"]
    assert torch.equal(model.bn.running_mean, running_mean)


def test_eval_step_spans(tracer):
    from monoflex_tpu_torch.train.train_step import make_eval_step

    seen = []

    def post(outputs, batch, output_depth=None):
        seen.append(outputs.shape)
        return outputs, outputs, {}

    eval_step = make_eval_step(TinyModel(), post)
    tracer.on()
    eval_step({"image": torch.randn(1, 3, 8, 8)})
    got = tracer.drain()
    assert names(got) == ["eval_step.forward", "eval_step.decode"] and seen


class Samples:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        time.sleep(0.002)
        return {"image": np.full((3, 4, 4), i, dtype=np.float32),
                "image_id": np.array(i, dtype=np.int32)}


def test_loader_spans_from_the_producer_thread(tracer):
    from monoflex_tpu_torch.data.loader import DataLoader, InferenceSampler

    tracer.on()
    loader = DataLoader(Samples(), InferenceSampler(6), batch_size=2, num_workers=2,
                        prefetch=1)
    batches = list(loader)
    got = tracer.drain()
    assert len(batches) == 3
    producer = [s for s in got.spans if s.thread == "loader"]
    assert [s.name for s in producer if s.name == "loader.build"] == ["loader.build"] * 3
    assert {s.name for s in producer} <= {"loader.build", "loader.put_wait"}
    assert all(s.parent is None for s in producer)
    # one wait a batch and one for the end of the stream
    assert names(got) == ["loader.wait"] * 4
    assert got.counters == {"loader.batches": 3}


def test_to_device_counts_its_bytes(tracer):
    from monoflex_tpu_torch.engine.inference import to_device

    batch = {"a": np.zeros((2, 3), np.float32), "b": np.zeros(5, np.uint8)}
    to_device(batch, "cpu")
    assert tracer.drain().counters == {}
    tracer.on()
    to_device(batch, "cpu")
    to_device(batch, "cpu")
    got = tracer.drain()
    assert names(got) == ["to_device"] * 2 and got.counters == {"to_device.bytes": 2 * 29}


class SlowLoader:
    """An endless loader whose batches take 30 ms to come, except every
    tenth: a meter that samples one iteration in ten reads near 0.  Each
    batch is built in a thread of its own, named as the port's producer, in
    a ``loader.build`` span, and counted in ``loader.batches``."""

    dataset = list(range(64))

    def __iter__(self):
        i = 0
        while True:
            i += 1
            out = []

            def build():
                with trace.span("loader.build"):
                    if i % 10:
                        time.sleep(0.03)
                    out.append({"image": np.random.rand(2, 3, 8, 8).astype(np.float32),
                                "poison": np.array(False)})

            th = threading.Thread(target=build, name="loader")
            th.start()
            th.join()
            trace.add("loader.batches")
            yield out[0]


def test_trainer_meters_and_profiled_trace(tracer, tmp_path, caplog, monkeypatch):
    from monoflex_tpu_torch.config import get_cfg_defaults
    from monoflex_tpu_torch.engine import trainer
    from monoflex_tpu_torch.engine.trainer import do_train
    from monoflex_tpu_torch.train.train_step import TrainState

    save = trainer.Checkpointer.save

    def slow_save(self, name, *args, **kwargs):
        if name.startswith("model_checkpoint_"):
            time.sleep(1.0)
        return save(self, name, *args, **kwargs)

    monkeypatch.setattr(trainer.Checkpointer, "save", slow_save)
    model, step, optimizer, schedule = tiny_step()
    cfg = get_cfg_defaults()
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.SOLVER.EVAL_AND_SAVE_EPOCH = False
    cfg.SOLVER.SAVE_CHECKPOINT_INTERVAL = 5
    logger = logging.getLogger("test.trainer")
    with caplog.at_level(logging.INFO, logger="test.trainer"):
        do_train(cfg, model, step, None, TrainState(), SlowLoader(), optimizer,
                 schedule=schedule, logger=logger, max_iter=10, profile_steps=5, device="cpu")
    messages = [r.getMessage() for r in caplog.records]
    line = next(m for m in messages if "iter 10/10" in m)
    data = float(re.search(r"data: (\S+)", line).group(1))
    # 9 of 10 iterations waited 30 ms; the 1 s save at iteration 5 is no
    # wait for data (counted, it would add 0.1 s an iteration)
    assert 0.02 < data < 0.08
    assert any(re.match(r"saved model_checkpoint_5 in 1\.", m) for m in messages)
    assert any("profiler trace of 5 steps" in m for m in messages)
    # iterations 2-6 were profiled: one batch each
    counters = next(m for m in messages if m.startswith("profiled counters: "))
    assert "loader.batches 5" in counters and "to_device.bytes " in counters
    with open(tmp_path / "profile" / "trace_rank0.json") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    pid = next(e["pid"] for e in events if e.get("ph") == "M"
               and e.get("args", {}).get("name") == "host spans")
    host = [e for e in events if e.get("pid") == pid and e.get("ph") == "X"]
    got = [e["name"] for e in host]
    assert got.count("train_step.optimizer") == 5 and got.count("to_device") == 5
    assert got.count("trainer.save") == 1         # the save inside the profiled steps
    assert all(e["dur"] >= 0 for e in host)
    # every thread's spans, one row a thread
    rows = {e["tid"]: e["args"]["name"] for e in events if e.get("pid") == pid
            and e.get("name") == "thread_name"}
    builds = [e for e in host if e["name"] == "loader.build"]
    assert len(builds) == 5 and {rows[e["tid"]] for e in builds} == {"loader"}
    assert rows[next(e["tid"] for e in host if e["name"] == "to_device")] == "MainThread"
    # the profiler's start stands in for the anchor on the CPU: the host spans
    # lie within the trace's own time range
    stamped = [e["ts"] for e in events if e.get("pid") != pid and "ts" in e]
    assert min(stamped) - 1e4 <= min(e["ts"] for e in host) <= max(stamped) + 1e4
    assert tracer.drain().spans == []         # the profile drained and switched it off
