"""Host ms a frame spends in ``eval_step.decode``
(``decode/postprocessor.py``, including any wait on the device it
makes), over the traced part."""

from mfbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "eval_step.decode")
