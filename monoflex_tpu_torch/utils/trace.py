"""Spans and counters inside the program, on ``time.perf_counter``.

``span(name)`` times a block and records a ``Span`` (name, start, end,
parent, thread): the parent is the name of the span open around it on the
same thread (a stack per thread), the thread its thread's name.
``add(name, n)`` adds to a counter; ``add_on_device(name, t)`` adds the sum
of a device tensor to one without waiting for the card (the sum stays on
the device, and ``drain()`` reads it).  Both are kept in memory until
``drain()`` returns them and starts afresh.  Names are dotted by layer
(``train_step.optimizer``, ``loader.wait``, ``to_device.bytes``).

Recording is off by default.  It is on between ``on()`` and ``off()``, and
while ``torch.profiler`` records (the flag the profiler sets on its start and
clears on its stop), so that a device trace always comes with the host spans
that explain its gaps, as ``torch.profiler.record_function`` ranges do.
Off, ``span()`` returns one shared context that does nothing (no
allocation, no clock read) and ``add()`` returns at once.

The anchor ties the spans to a device trace.  ``on()``, and otherwise the
first span the main thread records after a ``drain()``, synchronises the
card, reads the clock, launches one short marker kernel (``MARKER``) and
synchronises again; ``Drained.anchor`` is that host time.  A reader finds
the marker's start in the device trace: its offset from the anchor is the
offset between the trace's clock and this one (plus the launch latency, a
few microseconds).  Without a card there is no marker and the anchor is
None; switched on before the process first uses its card, the tracer
anchors at the first span after that.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

MARKER = "spin_kernel"        # the kernel torch.cuda._sleep launches
MARKER_CYCLES = 10_000        # a few microseconds


class Span(NamedTuple):
    name: str
    start: float
    end: float
    parent: Optional[str]
    thread: str


@dataclass
class Drained:
    spans: List[Span]
    counters: Dict[str, int]
    anchor: Optional[float]   # host time of the marker's launch, None without one


class _Stack(threading.local):
    def __init__(self):
        self.names: List[str] = []
        self.thread = threading.current_thread().name


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "local", "name", "start")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.local, self.name = tracer, tracer._local, name

    def __enter__(self):
        self.local.names.append(self.name)
        self.start = time.perf_counter()

    def __exit__(self, *exc):
        end = time.perf_counter()
        local = self.local
        names = local.names
        names.pop()
        # a plain tuple here; drain() makes them Spans
        self.tracer.spans.append((self.name, self.start, end, names[-1] if names else None,
                                  local.thread))


class Tracer:
    """Spans and counters of one process; the module's functions are those
    of ``TRACER``, the one the program's layers record into."""

    def __init__(self):
        self.enabled = False
        self.spans: List[tuple] = []
        self.counters: Dict[str, int] = {}
        self.device_counters: Dict[str, torch.Tensor] = {}
        self.anchor: Optional[float] = None
        self._anchored = False
        self._lock = threading.Lock()
        self._local = _Stack()

    def recording(self) -> bool:
        return self.enabled or _profiler._is_profiler_enabled

    def span(self, name: str):
        if not (self.enabled or _profiler._is_profiler_enabled):
            return _NO_SPAN
        if not self._anchored:
            self._take_anchor()
        return _Span(self, name)

    def add(self, name: str, n: int = 1) -> None:
        if not (self.enabled or _profiler._is_profiler_enabled):
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def add_on_device(self, name: str, t: torch.Tensor) -> None:
        if not (self.enabled or _profiler._is_profiler_enabled):
            return
        n = t.detach().sum(dtype=torch.int64)
        with self._lock:
            acc = self.device_counters.get(name)
            self.device_counters[name] = n if acc is None else acc + n

    def on(self) -> None:
        self.enabled = True
        self.anchor, self._anchored = None, False
        self._take_anchor()

    def off(self) -> None:
        self.enabled = False

    def drain(self) -> Drained:
        with self._lock:
            spans, counters, anchor = self.spans, self.counters, self.anchor
            on_device = self.device_counters
            self.spans, self.counters, self.device_counters = [], {}, {}
            self.anchor, self._anchored = None, False
        for name, n in on_device.items():
            counters[name] = counters.get(name, 0) + int(n)      # waits for the card
        return Drained([Span._make(t) for t in spans], counters, anchor)

    def _take_anchor(self) -> None:
        # the loader's threads never touch the card: only the main thread anchors
        if threading.current_thread() is not threading.main_thread():
            return
        if not torch.cuda.is_initialized():
            # no context yet: a later span anchors once the card is in use
            self._anchored = not torch.cuda.is_available()
            return
        self._anchored = True
        torch.cuda.synchronize()
        self.anchor = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()


TRACER = Tracer()
span = TRACER.span
add = TRACER.add
add_on_device = TRACER.add_on_device
on = TRACER.on
off = TRACER.off
drain = TRACER.drain
recording = TRACER.recording


def marker_start(ops: Iterable[Tuple[str, float, float]], anchor: Optional[float]
                 ) -> Optional[float]:
    """The start of the marker kernel nearest ``anchor`` among device ops
    (name, start, end), on their clock; None without an anchor or marker."""
    if anchor is None:
        return None
    starts = [s for name, s, _ in ops if MARKER in name]
    return min(starts, key=lambda s: abs(s - anchor)) if starts else None


def idle_by_span(ops: Iterable[Tuple[float, float]], spans: Iterable[Tuple[str, float, float]],
                 t0: float, t1: float) -> Dict[str, float]:
    """The device's idle time between ``t0`` and ``t1`` (outside the union
    of the ops' (start, end)), summed by the innermost span (name, start,
    end) open at each idle gap's midpoint, or "other"; one clock for all."""
    gaps, t = [], t0
    for s, e in sorted(ops):
        if s > t:
            gaps.append((t, min(s, t1)))
        t = max(t, e)
    if t1 > t:
        gaps.append((t, t1))
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [s for _, s, _ in spans]
    out: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        if e <= s:
            continue
        mid = (s + e) / 2
        name = "other"
        for n, ss, se in reversed(spans[:bisect.bisect_right(starts, mid)]):
            if mid < se:
                name = n     # the latest-starting open span is the innermost
                break
        out[name] += e - s
    return dict(out)
