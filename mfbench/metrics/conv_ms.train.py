"""Device ms per training step in the convolution kernels (cuDNN/cuBLAS;
the trunk, neck and head convolutions, forward and backward)."""

from mfbench.metrics._common import group_ms_per_call


def read(run):
    return group_ms_per_call(run, "convolutions")
