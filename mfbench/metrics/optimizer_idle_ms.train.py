"""Device idle ms a training step while the main thread is in
``train_step.optimizer`` (all of ``Optimizer.step``: AdamW, clip, EMA),
after the step's ``isfinite`` sync has drained the queue: the device ops
moved by the clock skew onto the host clock of the program's spans, over
the traced part; None where the trace holds no marker to tie the clocks."""

from mfbench.metrics._program import idle_within, in_window, program_trace


def read(run):
    pt = program_trace(run)
    if pt is None or pt.skew_s is None or not run.trace.ops:
        return None
    spans = in_window(run, pt.main, "train_step.")
    steps = sum(1 for n, _, _ in spans if n == "train_step.forward")
    if not steps:
        return None
    opt = [sp for sp in spans if sp[0] == "train_step.optimizer"]
    return idle_within(run.trace.gaps(), opt) * 1e3 / steps
