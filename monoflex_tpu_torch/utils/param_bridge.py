"""Flax ``params`` + ``batch_stats`` (as numpy) -> the port's state dict.

The JAX package maps reference torch names onto its flax tree with
``monoflex_tpu.utils.monoflex_import.monoflex_name_map``; the port's modules
carry those torch names, so the bridge runs that map in reverse and inverts
the layout converters of ``monoflex_tpu.utils.weight_import``.  It is strict:
every flax leaf and every state-dict entry is used exactly once, or it
raises.  BatchNorm's ``num_batches_tracked`` counters have no flax
counterpart and are set to 0.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from monoflex_tpu.utils.monoflex_import import monoflex_name_map
from monoflex_tpu.utils.weight_import import flatten_params

_STATS = "stats:"


def hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    """flax conv (kh, kw, I, O) -> torch (O, I, kh, kw); also depthwise
    (kh, kw, 1, C) -> (C, 1, kh, kw), the transposed-conv weight."""
    return np.transpose(w, (3, 2, 0, 1))


def conv1d_to_torch(w: np.ndarray) -> np.ndarray:
    """flax conv1d (k, I, O) -> torch (O, I, k)."""
    return np.transpose(w, (2, 1, 0))


def _to_torch_layout(w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:
        return hwio_to_oihw(w)
    if w.ndim == 3:
        return conv1d_to_torch(w)
    return w


def flax_to_state_dict(params: Any, batch_stats: Any, cfg) -> Dict[str, torch.Tensor]:
    """Every flax leaf, renamed and re-laid-out to the port's torch names."""
    trees = {False: flatten_params(params), True: flatten_params(batch_stats)}
    used = set()
    state: Dict[str, torch.Tensor] = {}
    for torch_name, flax_path in monoflex_name_map(cfg).items():
        is_stat = flax_path.startswith(_STATS)
        path = flax_path[len(_STATS):] if is_stat else flax_path
        if path not in trees[is_stat]:
            raise KeyError(f"{torch_name}: no flax leaf {flax_path}")
        if (is_stat, path) in used:
            raise KeyError(f"{torch_name}: flax leaf {flax_path} mapped twice")
        used.add((is_stat, path))
        state[torch_name] = torch.from_numpy(
            np.array(_to_torch_layout(np.asarray(trees[is_stat][path], np.float32))))
    unused = sorted((_STATS if s else "") + p for s in (False, True) for p in trees[s]
                    if (s, p) not in used)
    if unused:
        raise KeyError(f"flax leaves with no torch name: {unused}")
    return state


def load_flax_variables(model: torch.nn.Module, params: Any, batch_stats: Any, cfg) -> None:
    """Load a flax model's variables into ``model``, strictly."""
    state = flax_to_state_dict(params, batch_stats, cfg)
    expected = model.state_dict()
    for name, value in expected.items():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros_like(value)
    missing = sorted(set(expected) - set(state))
    unexpected = sorted(set(state) - set(expected))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, unexpected {unexpected}")
    for name, value in state.items():
        if value.shape != expected[name].shape:
            raise ValueError(f"{name}: flax gives {tuple(value.shape)}, "
                             f"model has {tuple(expected[name].shape)}")
    model.load_state_dict(state, strict=True)
