"""Host ms a training step spends in the program's ``train_step.*`` spans
(``train/train_step.py``: snapshot, forward, loss, backward, optimizer,
restore) other than ``finite_sync``, the wait on the device: what the host
costs a step, over the traced part."""

from mfbench.metrics._program import per_step_ms

NAMES = ("train_step.snapshot", "train_step.forward", "train_step.loss",
         "train_step.backward", "train_step.optimizer", "train_step.restore")


def read(run):
    return per_step_ms(run, NAMES)
