"""Ms the loader's producer thread takes to build one batch
(``loader.build``: its samples decoded, augmented and encoded by the
worker threads, then collated), over the traced part: the loader's
ceiling is the batch size over it."""

from mfbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "loader.build", main=False)
