"""One frame's forward FLOPs over (the median latency of the traced run's
frames after the profiler stopped x the chip's dense bf16 peak), in %."""

from mfbench.metrics._common import median_ms
from mfbench.work import PEAK_BF16_FLOPS


def read(run):
    ms = median_ms(run.latencies_s[len(run.trace_latencies_s):])
    if run.trace is None or ms is None:
        return None
    return 100.0 * run.work["forward_flops_per_image"] / (ms / 1e3 * PEAK_BF16_FLOPS)
