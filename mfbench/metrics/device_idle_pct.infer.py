"""100 x (1 - the union of device activity / the traced window), inference at batch 8."""

from mfbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
