"""Host ms a call spends in the program's span ``decode.nms``
(``decode/fcos3d.py``: the class-wise rotated BEV NMS, with its waits on
the device), over the traced part."""

from mfbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "decode.nms")
