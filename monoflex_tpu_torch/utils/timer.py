"""Wall-clock timer with per-call averaging (reference: utils/timer.py:7-44);
a copy of ``monoflex_tpu/utils/timer.py``.

CUDA work is asynchronous: callers synchronise (``torch.cuda.synchronize``)
on the timed work before toc()."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0

    def tic(self) -> None:
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        return self.average_time if average else self.diff

    @property
    def average_time(self) -> float:
        return self.total_time / max(self.calls, 1)
