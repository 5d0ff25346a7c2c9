"""Device busy ms per frame: the union of device activity in the traced
part over the frames it holds."""


def read(run):
    if run.trace is None or not run.trace_calls or not run.trace.ops:
        return None
    return run.trace.busy_s() * 1e3 / run.trace_calls
