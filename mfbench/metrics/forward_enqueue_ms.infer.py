"""Host ms a batch-8 call spends in ``eval_step.forward``
(``train/train_step.py::make_eval_step``: the model's forward enqueued in
eval mode), over the traced part."""

from mfbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "eval_step.forward")
