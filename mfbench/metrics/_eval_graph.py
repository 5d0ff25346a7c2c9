"""The share of the eval forwards that replayed a CUDA graph, for the
readers ``eval_graph_share.<cell kind>``."""

from __future__ import annotations

from typing import Optional

from mfbench.metrics._program import in_window, program_trace

FORWARD = "eval_step.forward"
REPLAYS = "eval_step.graph_replays"


def graph_share(run) -> Optional[float]:
    """The program's counter ``eval_step.graph_replays`` over its spans
    ``eval_step.forward`` in the traced part; None without the counter (a
    program that replays no graph) or without a forward."""
    pt = program_trace(run)
    if pt is None or REPLAYS not in pt.counters:
        return None
    forwards = sum(1 for n, _, _ in in_window(run, pt.main, FORWARD) if n == FORWARD)
    return pt.counters[REPLAYS] / forwards if forwards else None
