"""100 x (1 - the union of device activity / the traced window), FCOS3D at
one camera-rig sample a call."""

from mfbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
