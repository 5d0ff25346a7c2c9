"""Ms a step the main thread waits in ``loader.wait`` (``data/loader.py``:
the consumer's get on the producer's queue), over the traced part: the
in-program twin of ``data_wait_ms.train``."""

from mfbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "loader.wait")
