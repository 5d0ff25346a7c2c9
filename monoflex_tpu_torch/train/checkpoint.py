"""Checkpoint save / resume (counterpart of
``monoflex_tpu/train/checkpoint.py``; reference: utils/check_point.py:11-140).

The JAX package's names: periodic ``model_checkpoint_<it>``, ``model_final``,
metric-gated ``model_moderate_best_<OUTPUT_DEPTH>``, ``model_final_ema``,
``model_aborted``, and a ``last_checkpoint`` pointer file for resume-latest,
which the best and EMA saves leave alone (``tag_last=False``).  A checkpoint
is one ``torch.save`` file of tensors and plain containers: the unwrapped
model's ``state_dict`` (parameters and BN buffers), the optimizer's and the
EMA's (``train/solver.py``) and the ``TrainState`` counters.  Rank 0 writes
it atomically (a temporary file, then ``os.replace``); every process meets
at a barrier after.  ``SOLVER.LOAD_OPTIMIZER_SCHEDULER=False`` restores the
weights and BN stats only and starts at iteration 0, as does a checkpoint
whose optimizer or EMA structure differs from the run's (e.g. saved with
another ``SOLVER.EMA_DECAY``).

A JAX orbax checkpoint reaches the port as the ``.npz`` that
``convert_jax_checkpoint.py`` (repo root, run where JAX is) writes: the
weights and BN stats (``model/<name>``), the EMA shadow (``ema/<name>``,
``ema_count``), Adam's moments in torch layouts (``exp_avg/``,
``exp_avg_sq/``), their update count and the ``TrainState`` counters.  ``load`` takes such a file
wherever it takes a checkpoint (``--ckpt``, ``MODEL.WEIGHT``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils import comm
from .solver import Optimizer
from .train_step import TrainState

LAST_CHECKPOINT_FILE = "last_checkpoint"


class Checkpointer:
    def __init__(self, save_dir: str, load_optimizer_scheduler: bool = True):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self.load_optimizer_scheduler = load_optimizer_scheduler

    # -- save --------------------------------------------------------------
    def save(self, name: str, model: nn.Module, optimizer: Optimizer, state: TrainState,
             tag_last: bool = True) -> str:
        """Write ``model``'s weights and buffers as they are now (the caller
        swaps the EMA in for an EMA save), the optimizer and ``state``.
        Every process calls it; rank 0 writes."""
        path = os.path.join(self.save_dir, name)
        if comm.is_main_process():
            payload = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                       "state": {"step": state.step, "skips": state.skips}}
            tmp = f"{path}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
            if tag_last:
                tag = os.path.join(self.save_dir, LAST_CHECKPOINT_FILE)
                with open(f"{tag}.tmp", "w") as f:
                    f.write(name)
                os.replace(f"{tag}.tmp", tag)
        comm.synchronize(f"ckpt_save_{name}")
        return path

    # -- load --------------------------------------------------------------
    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.save_dir, LAST_CHECKPOINT_FILE))

    def get_checkpoint_file(self) -> Optional[str]:
        tag = os.path.join(self.save_dir, LAST_CHECKPOINT_FILE)
        if not os.path.exists(tag):
            return None
        with open(tag) as f:
            name = f.read().strip()
        return os.path.join(self.save_dir, name)

    def load(self, model: nn.Module, optimizer: Optimizer, path: Optional[str] = None
             ) -> Tuple[TrainState, int]:
        """Restore ``path`` (default: the one ``last_checkpoint`` names) into
        ``model`` and ``optimizer`` on the model's device; returns
        (TrainState, start iteration).  No checkpoint: (TrainState(), 0)."""
        path = path or self.get_checkpoint_file()
        if path is None or not os.path.exists(path):
            return TrainState(), 0
        device = next(model.parameters()).device
        if path.endswith(".npz"):
            return self._load_converted(path, model, optimizer, device)
        ckpt = torch.load(path, map_location=device, weights_only=True)
        model.load_state_dict(ckpt["model"])
        if not self.load_optimizer_scheduler:
            return TrainState(), 0
        try:
            optimizer.load_state_dict(ckpt["optimizer"])
        except ValueError:
            # structure mismatch: weights and stats only, as the JAX package
            return TrainState(), 0
        state = TrainState(step=int(ckpt["state"]["step"]), skips=int(ckpt["state"]["skips"]))
        return state, state.step

    def _load_converted(self, path: str, model: nn.Module, optimizer: Optimizer,
                        device) -> Tuple[TrainState, int]:
        """Restore a converted JAX checkpoint (``convert_jax_checkpoint.py``)."""
        arrays = read_converted(path)
        state = {k: v.to(device) for k, v in arrays["model"].items()}
        for name, value in model.state_dict().items():
            if name.endswith("num_batches_tracked") and name not in state:
                state[name] = torch.zeros_like(value)
        model.load_state_dict(state, strict=True)
        if not self.load_optimizer_scheduler:
            return TrainState(), 0
        try:
            optimizer.load_named_state(arrays["moments"], int(arrays["count"]),
                                       arrays["ema"], int(arrays["ema_count"]))
        except ValueError:
            # structure mismatch: weights and stats only, as for a torch file
            return TrainState(), 0
        train_state = TrainState(step=int(arrays["step"]), skips=int(arrays["skips"]))
        return train_state, train_state.step


def read_converted(path: str) -> Dict[str, object]:
    """A converted JAX checkpoint as {"model": {name: tensor}, "moments":
    {kind: {name: tensor}}, "ema": {name: tensor} or None, and the counters
    "count", "ema_count", "step", "skips"}."""
    with np.load(path, allow_pickle=False) as npz:
        out: Dict[str, object] = {"model": {}, "moments": {}, "ema": None}
        for key in npz.files:
            group, _, name = key.partition("/")
            if not name:
                out[group] = npz[key].item()
            elif group == "model":
                out["model"][name] = torch.from_numpy(npz[key])
            elif group == "ema":
                out["ema"] = out["ema"] or {}
                out["ema"][name] = torch.from_numpy(npz[key])
            else:
                out["moments"].setdefault(group, {})[name] = torch.from_numpy(npz[key])
    return out
