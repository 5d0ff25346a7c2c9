"""FCOS3D's evaluation path, built through the port's own factories
(``build_model`` is ``program.py``'s; this adds the decoder the config
names and the eval step), for ``kinds/infer_fcos3d.py``."""

from __future__ import annotations

from typing import Callable

import torch

from monoflex_tpu_torch.decode.postprocessor import build_postprocessor
from monoflex_tpu_torch.train.train_step import make_eval_step


def eval_step(cfg, m: torch.nn.Module) -> Callable:
    """eval_step(batch) -> (rows, valid, extras): the forward (a CUDA graph
    per input signature on the card) and FCOS3D's decode and NMS."""
    return make_eval_step(m, build_postprocessor(cfg))
