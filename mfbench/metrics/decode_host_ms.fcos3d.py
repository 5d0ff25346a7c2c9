"""Host ms an FCOS3D call spends in ``eval_step.decode``
(``decode/fcos3d.py``: the top-k, the boxes and the NMS, with their waits
on the device), over the traced part."""

from mfbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "eval_step.decode")
