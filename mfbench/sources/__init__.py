"""Where a cell's inputs come from: ``sources/<source>.py``, named by the
traffic mix's ``source`` and found by that name, makes a ``Feed`` from the
mix's parameters (``traffic/<mix>.json``) and the seed."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class Feed:
    """``next(i)``: the i-th input on the host; ``steps_per_epoch``: inputs
    before they repeat; ``close()``: stops what makes them.  ``pool``: a
    seeded host pool, cycled in order; ``judge_batches(record, tree)``: for a training cell fed by the data
    layer, the batches the reference trains on and the numbers that judge
    the layer's own batches (default: the recorded batches as they are)."""
    next: Callable[[int], Dict]
    steps_per_epoch: int
    close: Callable[[], None] = lambda: None
    pool: Optional[List[Dict]] = None
    judge_batches: Optional[Callable[[Dict, Dict], Tuple[List[Dict], Dict[str, float]]]] = None
