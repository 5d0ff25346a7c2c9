"""The share of BEVFormer's calls that were given the previous sample's BEV:
the program's counter ``bev.history_used`` over it and ``bev.scene_starts``
(``monoflex_tpu_torch/decode/bevformer.py``), over the traced part; 39/40
in scenes of 40 samples, 1.0 where no scene starts in the traced part.
None for a program without the counters."""

from mfbench.metrics._program import program_trace

USED, STARTS = "bev.history_used", "bev.scene_starts"


def read(run):
    pt = program_trace(run)
    if pt is None:
        return None
    used, starts = pt.counters.get(USED, 0), pt.counters.get(STARTS, 0)
    return used / (used + starts) if used + starts else None
