"""BEVFormer's evaluation path, built through the port's own factories
(``build_model`` is ``program.py``'s; this adds the decoder the config
names and the eval step), for ``kinds/infer_bevformer.py``.  Importing it
fails on a program without BEVFormer."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from monoflex_tpu_torch.decode.postprocessor import build_postprocessor
from monoflex_tpu_torch.models import bevformer
from monoflex_tpu_torch.train.train_step import make_eval_step


def eval_step(cfg, m: torch.nn.Module) -> Callable:
    """eval_step(batch) -> (rows, valid, extras): the forward (a CUDA graph
    per input signature on the card, the BEV history in the model) and the
    NMS-free decode."""
    return make_eval_step(m, build_postprocessor(cfg))


def set_grid(height: int, width: int, encoder_layers: int, decoder_layers: int,
             queries: int) -> Callable[[], None]:
    """Build later models with an (height, width) BEV grid, these depths and
    decoder queries (the tests' narrow size); returns what undoes it."""
    names = ("BEV_H", "BEV_W", "ENCODER_LAYERS", "DECODER_LAYERS", "NUM_QUERY")
    before = {n: getattr(bevformer, n) for n in names}
    for n, v in zip(names, (height, width, encoder_layers, decoder_layers, queries)):
        setattr(bevformer, n, v)

    def undo():
        for n, v in before.items():
            setattr(bevformer, n, v)
    return undo


def set_rotation(rotate: Optional[Callable]) -> Callable[[], None]:
    """Route the model's rotation of the history through ``rotate`` (a
    planted fault); returns what undoes it."""
    before = bevformer.rotate_bev
    bevformer.rotate_bev = rotate or before

    def undo():
        bevformer.rotate_bev = before
    return undo

