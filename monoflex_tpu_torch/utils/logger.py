"""Per-process logger (reference: utils/logger.py:8-33): non-zero processes
are silenced, process 0 logs to stdout + a timestamped file.  A copy of
``monoflex_tpu/utils/logger.py``."""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import Counter

_LOG_COUNTER: Counter = Counter()


def setup_logger(name: str, save_dir: str | None = None, rank: int = 0,
                 filename: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger
    if rank > 0:
        logger.addHandler(logging.NullHandler())
        return logger

    formatter = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(formatter)
    logger.addHandler(ch)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        filename = filename or time.strftime("log_%Y-%m-%d_%H-%M-%S.txt")
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def log_first_n(logger: logging.Logger, msg: str, n: int = 1,
                level: int = logging.INFO, key: str | None = None) -> None:
    key = key or msg
    _LOG_COUNTER[key] += 1
    if _LOG_COUNTER[key] <= n:
        logger.log(level, msg)
