"""Windowed metric tracking (reference: utils/metric_logger.py:8-74); a copy
of ``monoflex_tpu/utils/metric_logger.py``."""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Deque, Dict


class SmoothedValue:
    """Median/average over a sliding window, plus a global average."""

    def __init__(self, window_size: int = 20):
        self.deque: Deque[float] = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float) -> None:
        self.deque.append(float(value))
        self.count += 1
        self.total += float(value)

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr: str) -> SmoothedValue:
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())
