"""The program's own spans and counters for the readers that read them.

The program (``monoflex_tpu_torch/utils/trace.py``) records spans (name,
start, end, parent, thread) on ``time.perf_counter``, the harness's clock,
and counters, while torch.profiler records: in a traced run, over the
traced part of the window.  The first reader that asks drains the program's
tracer once for the run (from the loaded module: this file imports nothing
of the program) and finds the tracer's anchor in the device trace:
``clock_skew_us``, where the anchor's marker kernel starts in the
harness's mapping of device time less the host time it was launched at,
goes to stderr.  It then moves the run's device ops by that skew onto the
host clock (the readers of the harness's own metrics, listed first, have
read them by then; the busy union and each op's time are unchanged) and
adds the main thread's spans to the harness's spans, so that the
breakdown's idle gaps, summed after the readers, name the program's spans.
Both kinds of host span stay on one clock, so a program span still starts
after the harness span around it (moving the program's spans by the skew
instead would put a child before its parent, and ``Spans.at`` would then
name the parent).  Where the trace holds device ops but no marker (the
profiler dropped its record), the two clocks cannot be tied: the ops stay
as they are, the spans stay out of the breakdown, and the reader of device
time under a span gives None.  A trace with no device op (a CPU run) has
nothing to tie, and its skew is 0.  A program without the tracer gives
None, and so does every reader of it.
"""

from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

TRACER_MODULE = "monoflex_tpu_torch.utils.trace"
MARKER = "spin_kernel"          # the anchor's marker kernel (torch.cuda._sleep)
MAIN = "MainThread"
_KEY = "_program_trace"         # where the drained trace is kept on the Run


@dataclass
class ProgramTrace:
    """``main``: the main thread's spans (name, start, end) on the host
    clock; ``other``: other threads' (the loader's producer); ``counters``;
    ``skew_s``: the harness's device mapping less the host clock (the
    run's device ops have been moved by it), 0 without device ops, None
    with ops but no marker."""
    main: List[Tuple[str, float, float]] = field(default_factory=list)
    other: List[Tuple[str, float, float]] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    skew_s: Optional[float] = None


def clock_skew_s(ops, anchor: Optional[float]) -> Optional[float]:
    """The marker's start nearest ``anchor`` in the device ops, less
    ``anchor``; None without either."""
    if anchor is None:
        return None
    starts = [s for name, s, _ in ops if MARKER in name]
    return min(starts, key=lambda s: abs(s - anchor)) - anchor if starts else None


def program_trace(run) -> Optional[ProgramTrace]:
    """The run's ProgramTrace, drained on the first call of a traced run;
    None without a trace or without the program's tracer."""
    if run.trace is None:
        return None
    if _KEY in run.__dict__:
        return run.__dict__[_KEY]
    pt = None
    module = sys.modules.get(TRACER_MODULE)
    if module is not None:
        drained = module.drain()
        ops = run.trace.ops
        pt = ProgramTrace(counters=dict(drained.counters),
                          skew_s=clock_skew_s(ops, drained.anchor) if ops else 0.0)
        for s in drained.spans:
            (pt.main if s.thread == MAIN else pt.other).append((s.name, s.start, s.end))
        if pt.skew_s:
            run.trace.ops = [(n, s - pt.skew_s, e - pt.skew_s) for n, s, e in ops]
        if pt.skew_s is not None:
            run.spans.items.extend(pt.main)
        skew = "none" if pt.skew_s is None else repr(pt.skew_s * 1e6)
        print(f"mfbench: program spans {len(pt.main)} main, {len(pt.other)} other; "
              f"clock_skew_us {skew}", file=sys.stderr)
    run.__dict__[_KEY] = pt
    return pt


def in_window(run, spans, prefix: str) -> List[Tuple[str, float, float]]:
    """The spans whose name starts with ``prefix`` that lie in the traced
    part of the window (host clock)."""
    t0, t1 = run.trace.start, run.trace.end
    return [sp for sp in spans if sp[0].startswith(prefix) and sp[1] >= t0 and sp[2] <= t1]


def mean_ms(run, name: str, main: bool = True) -> Optional[float]:
    """Mean ms of the traced part's spans ``name`` (the main thread's or
    the others')."""
    pt = program_trace(run)
    if pt is None:
        return None
    got = [e - s for n, s, e in in_window(run, pt.main if main else pt.other, name) if n == name]
    return sum(got) * 1e3 / len(got) if got else None


def per_step_ms(run, names, step: str = "train_step.forward") -> Optional[float]:
    """Host ms a step in the main thread's spans ``names``, over the steps
    (spans ``step``) of the traced part."""
    pt = program_trace(run)
    if pt is None:
        return None
    spans = in_window(run, pt.main, "")
    steps = sum(1 for n, _, _ in spans if n == step)
    if not steps:
        return None
    return sum(e - s for n, s, e in spans if n in names) * 1e3 / steps


def idle_within(gaps: List[Tuple[float, float]], spans) -> float:
    """Seconds of the sorted, disjoint ``gaps`` that fall inside the spans."""
    starts = [s for s, _ in gaps]
    total = 0.0
    for _, s, e in spans:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(gaps) and gaps[i][0] < e:
            total += max(0.0, min(e, gaps[i][1]) - max(s, gaps[i][0]))
            i += 1
    return total
