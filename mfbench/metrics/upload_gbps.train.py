"""GB/s of ``to_device`` (``engine/inference.py``): the bytes it counts
(``to_device.bytes``) over the seconds in its spans, while the program's
tracer records (the traced part): pageable copies, with any wait behind
queued work."""

from mfbench.metrics._program import program_trace


def read(run):
    pt = program_trace(run)
    if pt is None:
        return None
    seconds = sum(e - s for n, s, e in pt.main if n == "to_device")
    nbytes = pt.counters.get("to_device.bytes", 0)
    return nbytes / seconds / 1e9 if seconds > 0 and nbytes else None
