"""The share of BEVFormer's calls (one sample of six cameras each) whose
forward replayed a CUDA graph (``monoflex_tpu_torch/train/eval_graph.py``),
over the traced part: scene starts and calls with history replay the
same graph."""

from mfbench.metrics._eval_graph import graph_share


def read(run):
    return graph_share(run)
