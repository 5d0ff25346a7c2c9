"""The training step's model FLOPs per image (forward and backward of the
frozen reference at the cell's shapes) x the images per second of the
traced run's steps after the profiler stopped, over the chip's dense bf16
peak, in %."""

from mfbench.metrics._common import mfu_pct


def read(run):
    return mfu_pct(run, "train_flops_per_image")
