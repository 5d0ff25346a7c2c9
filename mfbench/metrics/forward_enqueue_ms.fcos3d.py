"""Host ms an FCOS3D call spends in ``eval_step.forward``
(``train/train_step.py::make_eval_step``: the forward of six images
enqueued, or its graph replayed), over the traced part."""

from mfbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "eval_step.forward")
