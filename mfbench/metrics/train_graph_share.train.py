"""The share of the training steps whose step replayed a CUDA graph
(``monoflex_tpu_torch/train/train_graph.py``): the program's counter
``train_step.graph_replays`` over its spans ``train_step.forward`` (one a
step, eager or replayed) in the traced part; None without the counter (a
program that replays no graph) or without a step."""

from mfbench.metrics._program import in_window, program_trace

FORWARD = "train_step.forward"
REPLAYS = "train_step.graph_replays"


def read(run):
    pt = program_trace(run)
    if pt is None or REPLAYS not in pt.counters:
        return None
    steps = sum(1 for n, _, _ in in_window(run, pt.main, FORWARD) if n == FORWARD)
    return pt.counters[REPLAYS] / steps if steps else None
