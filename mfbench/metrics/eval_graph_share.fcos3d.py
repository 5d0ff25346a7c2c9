"""The share of FCOS3D's calls (one camera-rig sample each) whose forward
replayed a CUDA graph (``monoflex_tpu_torch/train/eval_graph.py``), over the
traced part."""

from mfbench.metrics._eval_graph import graph_share


def read(run):
    return graph_share(run)
