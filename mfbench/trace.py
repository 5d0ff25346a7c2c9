"""Spans of the harness and the device trace, and their reduction.

The harness records a host span (name, start, end) around each call into a
layer of the program.  In a traced run ``torch.profiler`` records the
device's operations (CUDA activity only: tracing every host op would slow
the host-bound steps it measures) over the first part of the window.  The
kernel groups follow
``monoflex_tpu_torch/tools/profile_split.py::GROUPS`` and ``busy_ms``, with
batch norm matched before the convolutions (cuDNN names its batch-norm
kernels ``cudnn::batchnorm_*`` and ``cudnn::bn_*``), cuDNN's tensor
transforms counted as layout, and every kernel a DCN backward entry
launches in its own group.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# kernel name -> group, first match wins (names as the H100's libraries give them)
GROUPS = (
    ("dcn_fwd", ("dcn_fwd_kernel", "fwd_weight_image")),
    ("dcn_bwd_dx", ("dcn_bwd_dx", "dx_weight_image", "dx_wide_")),
    ("dcn_bwd_dwmo", ("dcn_bwd_mo", "dcn_bwd_dw", "dwmo_weight_image")),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw", "transpose", "Transpose",
                           "tensorTransform")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford", "Welford")),
    ("convolutions", ("conv", "Conv", "xmma", "gemm", "Gemm", "sm90_", "sm80_",
                      "cutlass", "cudnn", "dgrad", "wgrad")),
    ("optimizer", ("multi_tensor", "foreach", "adam", "Adam")),
    ("reductions", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized", "unrolled")),
    ("copies", ("Memcpy", "Memset", "copy", "Copy")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) spans as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of the spans."""
    return sum(e - s for s, e in union(spans))


class Spans:
    """Host spans on ``time.perf_counter``: ``with spans("name"): ...``."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []
        self._starts: Optional[List[float]] = None

    def __call__(self, name: str) -> "_Span":
        return _Span(self, name)

    def total(self, name: str, t0: float = float("-inf"), t1: float = float("inf")) -> float:
        return sum(e - s for n, s, e in self.items if n == name and s >= t0 and e <= t1)

    def count(self, name: str, t0: float = float("-inf"), t1: float = float("inf")) -> int:
        return sum(1 for n, s, e in self.items if n == name and s >= t0 and e <= t1)

    def at(self, t: float, depth: int = 4) -> str:
        """The innermost span open at host time ``t``, or "other" (spans
        nest at most ``depth`` deep)."""
        if self._starts is None or len(self._starts) != len(self.items):
            self.items.sort(key=lambda it: it[1])
            self._starts = [s for _, s, _ in self.items]
        i = bisect.bisect_right(self._starts, t)
        for n, s, e in reversed(self.items[max(0, i - depth):i]):
            if t < e:
                return n
        return "other"


class _Span:
    def __init__(self, owner: Spans, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.owner.items.append((self.name, self.t0, time.perf_counter()))


@dataclass
class DeviceTrace:
    """Device operations of a traced window, on the host clock: ``start``
    and ``end`` bound the window; ``ops`` are (name, start, end)."""
    start: float
    end: float
    ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return busy([(s, e) for _, s, e in self.ops])

    def group_s(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            out[group_of(name)] += e - s
        return dict(out)

    def top_ops(self, n: int = 10) -> List[List]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            out[name[:160]] += e - s
        return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals between the window's start and end."""
        out, t = [], self.start
        for s, e in union([(s, e) for _, s, e in self.ops]):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end > t:
            out.append((t, self.end))
        return out

    def idle_by_span(self, spans: Spans, n: int = 10) -> List[List]:
        """The device's idle seconds summed by the host span open at each
        gap's midpoint, longest first."""
        out: Dict[str, float] = defaultdict(float)
        for s, e in self.gaps():
            out[spans.at((s + e) / 2)] += e - s
        return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]


class Profiler:
    """torch.profiler over CUDA activity between ``start()`` and ``stop()``;
    ``stop()`` synchronises first and returns the DeviceTrace, its device
    times mapped onto the host clock by the profiler's start."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        # a CPU run (the tests) traces the host, whose ops are no device's
        self.prof = profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                                        else ProfilerActivity.CPU])
        self.t0: Optional[float] = None

    def start(self) -> None:
        before = time.perf_counter()
        self.prof.start()
        self.t0 = (before + time.perf_counter()) / 2

    def stop(self) -> DeviceTrace:
        import torch
        from torch.autograd import DeviceType

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        end = time.perf_counter()
        self.prof.stop()
        ops = [(e.name, self.t0 + e.time_range.start / 1e6, self.t0 + e.time_range.end / 1e6)
               for e in self.prof.events() if e.device_type == DeviceType.CUDA]
        return DeviceTrace(self.t0, end, ops)
