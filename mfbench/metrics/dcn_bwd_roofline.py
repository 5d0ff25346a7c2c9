"""The DCN backward's share of its roofline (``dcn_bwd_dx`` and
``dcn_bwd_dwmo``): the 16 backwards' least time on the chip (``work.py``)
over their device time, per step."""

from mfbench.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "bwd", "dcn_bwd_dx", "dcn_bwd_dwmo")
