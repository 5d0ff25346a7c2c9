"""Device time of a callable from a torch.profiler trace of the card, the
counterpart of the JAX package's ``tools/trace_time.py``.

    from monoflex_tpu_torch.tools.trace_time import device_time
    ms_per_call, by_op = device_time(lambda: fn(x), iters=3)

There is no jit umbrella event on the GPU: ``ms_per_call`` is the sum of the
durations of every device activity (kernels, memsets, copies) the calls ran,
divided by ``iters``; ``by_op`` maps each kernel name to its device ms per
call.  Gaps between kernels are not counted.

The profiler can drop device records from a trace (seen on an H100: one
trace kept 1 of 3 launches, the next none).  Every call of ``fn`` launches
the same kernels, so a whole trace holds each kernel name a multiple of
``iters`` times; a trace that does not is taken again, and after
``ATTEMPTS`` such traces ``device_time`` raises.
"""

from __future__ import annotations

import collections
import sys
from typing import Callable, Dict, Mapping, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ATTEMPTS = 3


def trace_is_whole(counts: Mapping[str, int], iters: int) -> bool:
    """Whether a trace of ``iters`` identical calls holds every device
    record: some activity, each name seen a multiple of ``iters`` times."""
    return bool(counts) and all(n % iters == 0 for n in counts.values())


def device_time(fn: Callable, iters: int = 3) -> Tuple[float, Dict[str, float]]:
    """Run fn() once to warm up, then ``iters`` times under the profiler;
    return (device ms per call, {kernel name: device ms per call})."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_op, counts = collections.Counter(), collections.Counter()
        for event in prof.events():
            if event.device_type == DeviceType.CUDA:
                by_op[event.name] += event.time_range.elapsed_us()
                counts[event.name] += 1
        if trace_is_whole(counts, iters):
            per_call = {name: us / iters / 1e3 for name, us in by_op.items()}
            return sum(per_call.values()), per_call
        print(f"trace_time: trace {attempt + 1} of {ATTEMPTS} lost device records "
              f"({dict(counts)} for {iters} calls)", file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler lost device records in {ATTEMPTS} traces: "
                       "no device time to report")
