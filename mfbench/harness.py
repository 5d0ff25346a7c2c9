"""One run of one cell: set-up, the measured window, the check, the line.

    python3 mfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the configuration's model on the card from the seed, makes the
traffic mix's inputs, builds the cell's call (the training step or the
evaluation path's forward and decode) and drives it through its first calls,
which compile, autotune and, in a training cell, give the steps the check
compares.  The window then drives the same call for ``--seconds``: a closed
loop (the next call starts when the last is done) or an open one (frames
due at a fixed rate; each timed from when it was due).  With ``--trace 1``
torch.profiler records the device over the first ``trace_seconds`` of the
window, and the line carries the per-layer metrics instead of the
end-to-end ones.  After the window the program is freed and the plain
reference (``reference/``) judges what the timed path produced.

Everything that belongs to one cell is found by name: the configuration
(``configs/<config>.json``), the traffic mix (``traffic/<mix>.json``, data
only), what its kind of traffic drives and how it is judged
(``kinds/<kind>.py``), where its inputs come from (``sources/<source>.py``),
each metric's reader (``metrics/<name>.py``) and the cell's limits
(``limits/<cell>.json``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .trace import Spans

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_cache")
BANNED = ("jax", "jaxlib", "flax", "monoflex_tpu")


def process_start() -> float:
    """This process's start on the ``time.time`` clock (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def set_environment() -> None:
    """Fixed compile caches inside the checkout; keep libraries from
    loading JAX."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (whole names: ``monoflex_tpu_torch`` is not ``monoflex_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


@dataclass
class Run:
    """What a run measured; the metric readers (``metrics/``) read it."""
    cell: str
    kind: str                      # "train" or "infer"
    batch: int
    window_s: float = 0.0
    calls: int = 0                 # steps or forward+decode calls in the window
    setup_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    lateness_s: List[float] = field(default_factory=list)
    skipped: int = 0
    spans: Spans = field(default_factory=Spans)
    trace: object = None           # trace.DeviceTrace of the traced part
    trace_calls: int = 0           # calls that finished in the traced part
    trace_latencies_s: List[float] = field(default_factory=list)
    untraced_calls: int = 0        # calls after the traced part, to the window's end
    untraced_s: float = 0.0        # their seconds: from the profiler's stop to the end
    decode_ms: List[float] = field(default_factory=list)
    x_bytes: int = 4               # bytes of an activation the DCN receives
    height: int = 0
    width: int = 0
    work: Dict = field(default_factory=dict)   # the configuration file's "work"

    def images_per_s(self) -> float:
        return self.calls * self.batch / self.window_s

    def untraced_images_per_s(self) -> Optional[float]:
        """Images per second over the traced run's calls after the
        profiler stopped (none of its cost in them); None without any."""
        if self.untraced_calls <= 0 or self.untraced_s <= 0:
            return None
        return self.untraced_calls * self.batch / self.untraced_s


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, by linear interpolation
    between order statistics (numpy's default)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def load_module(folder: str, name: str):
    """``mfbench/<folder>/<name>.py``, found by the name ``BENCHMARK.json``
    or a data file gives it (a name may hold dots), loaded once."""
    import importlib.util

    key = f"mfbench.{folder}.{name}"
    if key not in _LOADED:
        path = os.path.join(HERE, folder, f"{name}.py")
        if not os.path.exists(path):
            raise SystemExit(f"mfbench: no {folder}/{name}.py")
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[key] = module
    return _LOADED[key]


_LOADED: Dict[str, object] = {}


def read_metric(name: str, run: Run) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(run)`` (an end-to-end or a per-layer
    metric): None where it finds nothing."""
    return load_module("metrics", name).read(run)


# ---------------------------------------------------------------------------
# the window


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(run: Run, call: Callable[[int], None], seconds: float, trace_seconds: float,
           device, rate_hz: float = 0.0, on_trace_stop: Callable[[], None] = lambda: None):
    """Drive ``call(i)`` for ``seconds``, closed loop, or open at
    ``rate_hz`` (frame i due at start + i / rate; its latency runs from
    then to the end of its call, which returns once its rows are on the
    host).  A profiler, when ``trace_seconds`` > 0, covers the calls that
    start in the first ``trace_seconds``."""
    from .trace import Profiler

    prof = None
    if trace_seconds > 0:
        warm = Profiler()         # the profiler's own first start, outside the window
        warm.start()
        warm.stop()
        prof = Profiler()
    sync(device)
    t0 = time.perf_counter()
    if prof is not None:
        prof.start()
        t0 = prof.t0
    end = t0 + seconds
    base = t0                      # frame i is due at base + i / rate_hz
    i = 0
    tracing = prof is not None
    while True:
        now = time.perf_counter()
        if rate_hz > 0:
            due = base + i / rate_hz
            if due >= end:
                break
            if now < due:
                with run.spans("pace"):
                    if due - now > 2e-3:
                        time.sleep(due - now - 1e-3)
                    while time.perf_counter() < due:
                        pass
                run.lateness_s.append(time.perf_counter() - due)
        elif now >= end:
            break
        if tracing and (now if rate_hz <= 0 else max(now, due)) >= t0 + trace_seconds:
            run.trace = prof.stop()
            run.trace_calls = i
            run.trace_latencies_s = list(run.latencies_s)
            on_trace_stop()
            tracing = False
            untraced_t0 = time.perf_counter()
            if rate_hz > 0 and untraced_t0 > due:
                # the schedule resumes once the profiler has stopped: its
                # seconds are no frame's wait (a traced run reports no tail)
                lag = untraced_t0 - due
                base, end, due = base + lag, end + lag, due + lag
        call(i)
        if rate_hz > 0:
            run.latencies_s.append(time.perf_counter() - due)
        i += 1
    sync(device)
    t_end = time.perf_counter()
    run.window_s = t_end - t0
    run.calls = i
    if prof is not None and not tracing:
        run.untraced_calls = i - run.trace_calls
        run.untraced_s = t_end - untraced_t0
    if tracing:
        run.trace = prof.stop()
        run.trace_calls = i
        run.trace_latencies_s = list(run.latencies_s)
        on_trace_stop()


# ---------------------------------------------------------------------------
# cells


def shapes(cfg_tree: Dict, traffic: Dict, overrides: Dict) -> Dict:
    inp = cfg_tree["INPUT"]
    kind = traffic["kind"]
    out = {"batch": traffic["batch"],
           "height": inp["HEIGHT_TRAIN" if kind == "train" else "HEIGHT_TEST"],
           "width": inp["WIDTH_TRAIN" if kind == "train" else "WIDTH_TEST"]}
    out.update({k: v for k, v in overrides.items() if k in out})
    return out


def tree_with(cfg_tree: Dict, shape: Dict) -> Dict:
    """The configuration's tree at the cell's batch and input size."""
    tree = json.loads(json.dumps(cfg_tree))
    inp = tree["INPUT"]
    inp["HEIGHT_TRAIN"] = inp["HEIGHT_TEST"] = shape["height"]
    inp["WIDTH_TRAIN"] = inp["WIDTH_TEST"] = shape["width"]
    tree["SOLVER"]["IMS_PER_BATCH"] = shape["batch"]
    return tree


def device_info(device, chips: int) -> Dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def parse(argv=None):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Session:
    """One run of a cell up to its check: ``measure()`` builds, sets up and
    drives the window; ``judge(precision)`` compares what the program
    produced with the reference (or, with a control's precision, the
    control with the reference); ``close()`` removes the run's files.  What
    a kind of traffic does (``kinds/<kind>.py``) and where its inputs come
    from (``sources/<source>.py``) are found by the names in the mix's file.
    ``device``, ``overrides`` (batch, height, width, pool, frames,
    frame_size, check_calls, trace_seconds) and ``faults`` are for the
    tests and the control runs: the benchmark runs on the card, at the
    cell's sizes, unbroken."""

    def __init__(self, args, device: str, overrides: Optional[Dict] = None,
                 faults: Optional[List[str]] = None):
        from .spec import load_cell

        overrides = overrides or {}
        self.args, self.device, self.faults = args, device, list(faults or ())
        self.cell = cell = load_cell(args.workload)
        for key in ("pool", "check_calls", "frames", "frame_size"):
            if key in overrides:
                cell.traffic[key] = overrides[key]
        trace_seconds = float(overrides.get("trace_seconds", cell.traffic["trace_seconds"]))
        self.trace_seconds = trace_seconds if args.trace else 0.0
        shape = shapes(cell.config["cfg"], cell.traffic, overrides)
        self.tree = tree_with(cell.config["cfg"], shape)
        self.weights = cell.config["weights"]
        self.kind = cell.traffic["kind"]
        self.driver = load_module("kinds", self.kind)
        self.run = Run(cell=cell.name, kind=self.kind, batch=shape["batch"],
                       x_bytes=2 if self.tree["TPU"]["COMPUTE_DTYPE"] == "bfloat16" else 4,
                       height=shape["height"], width=shape["width"], work=cell.config["work"])
        self.shape = shape
        self.scratch = None
        self.feed = None
        self.outputs = None
        self.buffers: Dict = {}
        self.excluded_s = 0.0      # set-up seconds that are the reference's, not the program's
        self.device_line: Dict = {}

    def measure(self) -> None:
        import torch

        from . import program as prog

        self.scratch = tempfile.mkdtemp(prefix="mfbench-")
        cfg = prog.config(self.tree)
        source = load_module("sources", self.cell.traffic["source"])
        self.feed = source.make(self.cell.traffic, self.shape, self.args.seed, prog, cfg,
                                self.scratch)
        if hasattr(self.driver, "prepare"):
            self.driver.prepare(self)
        model = prog.model(cfg, self.weights, self.args.seed, self.device)
        if self.buffers:
            from .weights import load_buffers

            load_buffers(model, self.buffers)
        if torch.device(self.device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.driver.drive(self, prog, cfg, model)
        self.device_line = device_info(self.device, self.cell.chips)
        self.feed.close()
        del model
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, precision: str = "stated") -> Dict[str, float]:
        return self.driver.judge(self, precision)

    def close(self) -> None:
        if "mfbench.program" in sys.modules:
            sys.modules["mfbench.program"].restore_dcn()
        if self.scratch:
            shutil.rmtree(self.scratch, ignore_errors=True)

    def result(self, numbers: Dict[str, float]) -> Dict:
        from .check import verdict

        cell, run = self.cell, self.run
        correct, table = verdict(numbers, cell.limits["limits"])
        result = {"correct": bool(correct), "attempted": run.calls * run.batch,
                  "failed": self.driver.failed(self) * run.batch}
        dev = dict(self.device_line)
        metrics = {}
        for m in (cell.per_layer if self.args.trace else cell.end_to_end):
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if self.args.trace:
            dev["busy_s"] = run.trace.busy_s() if run.trace else 0.0
            dev["window_s"] = run.trace.window_s if run.trace else 0.0
        result.update(metrics=metrics, device=dev)
        if self.args.trace and run.trace is not None:
            result["breakdown"] = {"device_ops": run.trace.top_ops(),
                                   "idle_gaps": run.trace.idle_by_span(run.spans)}
        result["checks"] = table
        return result


def require_cards(chips: int, workload: str) -> None:
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"mfbench: {workload} needs {chips} CUDA card(s), found {have}", file=sys.stderr)
        raise SystemExit(2)


def main(argv=None, device: Optional[str] = None, overrides: Optional[Dict] = None,
         faults: Optional[List[str]] = None) -> Dict:
    """One run; prints the result line and returns it.  ``device`` other
    than None (the tests: "cpu") skips the look for a card."""
    args = parse(argv)
    args.process_start = process_start()
    set_environment()
    session = Session(args, device or "cuda", overrides, faults)
    if device is None:
        require_cards(session.cell.chips, args.workload)
    try:
        session.measure()
        numbers = session.judge()
    finally:
        session.close()
    result = session.result(numbers)
    info(session.run, args)
    banned = banned_modules()
    if banned:
        print(f"mfbench: the run loaded {banned}", file=sys.stderr)
        raise SystemExit(3)
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return result


def info(run: Run, args) -> None:
    """The lines before the result: counts, medians and how late the
    generator ran."""
    line = {"cell": run.cell, "seed": args.seed, "calls": run.calls,
            "window_s": run.window_s, "setup_s": run.setup_s, "skipped": run.skipped}
    if run.latencies_s:
        line.update(frames=len(run.latencies_s),
                    latency_median_ms=statistics.median(run.latencies_s) * 1e3,
                    latency_p95_ms=percentile(run.latencies_s, 95) * 1e3,
                    latency_max_ms=max(run.latencies_s) * 1e3)
    if run.lateness_s:
        line.update(generator_late_median_ms=statistics.median(run.lateness_s) * 1e3,
                    generator_late_max_ms=max(run.lateness_s) * 1e3)
    print(json.dumps(line), flush=True)
