"""FCOS3D's forward FLOPs per image x the images per second of the traced
run's calls after the profiler stopped, over the chip's dense bf16 peak,
in %."""

from mfbench.metrics._common import mfu_pct


def read(run):
    return mfu_pct(run, "forward_flops_per_image")
