"""Host ms a frame spends in ``eval_step.forward`` (the batch-1 forward
enqueued), over the traced part."""

from mfbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "eval_step.forward")
