"""dcn_fwd's share of its roofline: the 16 DCN forwards' least time on the
chip (``work.py``: contraction FLOPs at the bf16 peak or bytes at the
memory rate, whichever is longer) over their device time, per call."""

from mfbench.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "fwd", "dcn_fwd")
