"""The multi-scale deformable attention's share of its roofline in
BEVFormer's forward: the 18 calls' least time on the chip
(``work_bevformer.py``: each call's bytes at the memory rate or its blend at
the f32 rate, whichever is longer, at its own shape, the configuration's
``work.msda_calls``) over their device time (kernels named
``msda_fwd_kernel``), per call.  None at another input size than the one
the calls were counted at, or without such a kernel."""

from mfbench.work_bevformer import calls_bound_s

KERNEL = "msda_fwd_kernel"


def read(run):
    calls, at = run.work.get("msda_calls"), run.work.get("at", {})
    if not calls or (run.height, run.width) != (at.get("height"), at.get("width")):
        return None
    if run.trace is None or not run.trace_calls:
        return None
    busy = sum(e - s for name, s, e in run.trace.ops if KERNEL in name)
    if busy <= 0:
        return None
    return 100.0 * calls_bound_s(calls, run.x_bytes, run.x_bytes) * run.trace_calls / busy
