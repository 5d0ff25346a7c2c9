"""100 x (1 - the union of device activity / the traced window), training."""

from mfbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
