"""The 95th percentile over every frame due in the window of the time
from when it was due to when its decoded rows were in host memory."""

from mfbench.harness import percentile


def read(run):
    return percentile(run.latencies_s, 95) * 1e3 if run.latencies_s else None
