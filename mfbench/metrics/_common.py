"""Shared arithmetic of the metric readers (``metrics/<name>.py``), which
``harness.read_metric`` loads by the metric's name."""

from __future__ import annotations

import statistics
from typing import List, Optional

from mfbench.work import PEAK_BF16_FLOPS, DcnLayer, layers_bound_s


def dcn_layers(run) -> List[DcnLayer]:
    """The configuration's DCN calls at the run's batch and input size."""
    return [DcnLayer(run.batch, run.height // s, run.width // s, c, co)
            for s, c, co in run.work["dcn_layers"]]


def group_ms_per_call(run, *groups: str) -> Optional[float]:
    """Device ms per call of the window's traced part in these kernel groups;
    None without a trace, a call or any such kernel."""
    if run.trace is None or not run.trace_calls:
        return None
    by_group = run.trace.group_s()
    total = sum(by_group.get(g, 0.0) for g in groups)
    return total * 1e3 / run.trace_calls if total > 0 else None


def roofline_pct(run, kind: str, *groups: str) -> Optional[float]:
    """100 x the DCN calls' bound over their device time, per call."""
    ms = group_ms_per_call(run, *groups)
    if ms is None:
        return None
    return 100.0 * layers_bound_s(dcn_layers(run), run.x_bytes, kind) * 1e3 / ms


def mfu_pct(run, flops_key: str) -> Optional[float]:
    """100 x FLOPs per image x the images per second of the traced run's
    calls after the profiler stopped (its own cost is in none of them),
    over the bf16 dense peak; None without such calls."""
    rate = run.untraced_images_per_s() if run.trace is not None else None
    if rate is None:
        return None
    return 100.0 * run.work[flops_key] * rate / PEAK_BF16_FLOPS


def idle_pct(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def median_ms(values) -> Optional[float]:
    return statistics.median(values) * 1e3 if values else None
