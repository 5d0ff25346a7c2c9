"""Host ms a training step spends in ``train_step.snapshot``, the copy of
every BN buffer the non-finite guard restores from, over the traced part."""

from mfbench.metrics._program import per_step_ms


def read(run):
    return per_step_ms(run, ("train_step.snapshot",))
