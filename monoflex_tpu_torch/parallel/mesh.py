"""Data parallelism (counterpart of ``monoflex_tpu/parallel/mesh.py``).

The JAX package runs one step over a 1-D ``data`` mesh, in which GSPMD
all-reduces the gradients and makes BatchNorm statistics global.  Here each
process drives one card (or the CPU, under gloo) and holds its own part of
the batch: the train loader is rank-strided (``data/loader.py``), so no
batch is sharded here.  ``DistributedDataParallel`` all-reduces the
gradients; the global BN statistics are ``models/batchnorm.py``'s and the
global loss normalisers ``losses/``'s.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..utils import comm


def wrap_model(model: nn.Module, device) -> nn.Module:
    """``model`` in DistributedDataParallel while a process group is up
    (``engine/launch.py``), at any world size, so one process started with
    the process flags runs the same path as many; ``model`` itself otherwise.

    ``find_unused_parameters=True``: a few parameters get no gradient from
    the loss (the projection of a tree whose output feeds nothing), and
    ``Optimizer.step`` gives them zeros as JAX does; without it DDP stops at
    the first step waiting for their gradients.  ``broadcast_buffers=False``:
    every process folds the same global batch statistics into its BN
    buffers, so there is nothing to broadcast.  Build the optimizer and the
    EMA on ``model``, not on the wrapper (parameter names without
    ``module.``)."""
    if not comm.is_initialized():
        return model
    device = torch.device(device)
    if device.type == "cuda":
        device_ids = [torch.cuda.current_device() if device.index is None else device.index]
    else:
        device_ids = None
    return DistributedDataParallel(
        model, device_ids=device_ids,
        find_unused_parameters=True, broadcast_buffers=False)
