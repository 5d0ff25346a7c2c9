"""dcn_fwd's share of its roofline in FCOS3D's forward: the 36 DCN calls'
least time on the chip (``work.py``: contraction FLOPs at the bf16 peak or
bytes at the memory rate, whichever is longer, each call at its own map
and widths, the configuration's ``work.dcn_calls``) over their device time
(the ``dcn_fwd`` kernel group), per call.  None at another input size than
the one the calls were counted at."""

from mfbench.metrics._common import group_ms_per_call
from mfbench.work import DcnLayer, layers_bound_s


def read(run):
    calls, at = run.work.get("dcn_calls"), run.work.get("at", {})
    if not calls or (run.height, run.width) != (at.get("height"), at.get("width")):
        return None
    ms = group_ms_per_call(run, "dcn_fwd")
    if ms is None:
        return None
    layers = [DcnLayer(run.batch, h, w, c, co) for h, w, c, co in calls]
    return 100.0 * layers_bound_s(layers, run.x_bytes, "fwd") * 1e3 / ms
