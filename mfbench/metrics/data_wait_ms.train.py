"""Host ms per step spent waiting on the loader's ``next()`` (the harness's
span around it), over the window's traced part: the data layer
(``data/loader.py``, ``dataset.py``, ``target_encoder.py``)."""


def read(run):
    if run.trace is None:
        return None
    t0, t1 = run.trace.start, run.trace.end
    n = run.spans.count("data_wait", t0, t1)
    return run.spans.total("data_wait", t0, t1) * 1e3 / n if n else None
