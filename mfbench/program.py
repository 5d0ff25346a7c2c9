"""The system under test: the one module of the benchmark that imports
``monoflex_tpu_torch``.  It builds what a user's job builds, through the
port's own layers, and hands the harness the calls the window drives."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.dataset import KITTIDataset
from monoflex_tpu_torch.data.loader import make_train_loader
from monoflex_tpu_torch.decode.postprocessor import PostProcessor
from monoflex_tpu_torch.engine.inference import to_device
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.models.backbone import dla as _dla
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.train.solver import build_optimizer
from monoflex_tpu_torch.train.train_step import TrainState, make_eval_step, make_train_step

from .weights import apply_recipe

__all__ = ["to_device", "TrainState", "config", "model", "train_step", "eval_step",
           "train_loader", "first_moments", "adam_beta1", "wrap_dcn", "restore_dcn"]


def config(tree: Dict):
    """The program's config node holding the configuration file's tree."""
    cfg = get_cfg_defaults()
    cfg.merge_from_other(tree)
    return cfg


def model(cfg, weights: Dict, seed: int, device) -> torch.nn.Module:
    """``build_model`` from the seed, then the benchmark's part of the
    weights (``weights.py``)."""
    m = build_model(cfg, device=device, seed=seed)
    apply_recipe(m, seed, weights)
    return m


def train_step(cfg, m: torch.nn.Module, steps_per_epoch: int) -> Tuple[Callable, object]:
    """(train_step(state, batch) -> (state, metrics), optimizer), as the
    training entry point builds them at world size 1."""
    optimizer, _, _ = build_optimizer(cfg, m, steps_per_epoch)
    return make_train_step(m, LossComputer(cfg), optimizer), optimizer


def eval_step(cfg, m: torch.nn.Module, wrap: Callable = lambda post: post) -> Callable:
    """eval_step(batch) -> (rows, valid, extras), the evaluation path's
    forward and decode; ``wrap`` may put a span around the decode."""
    return make_eval_step(m, wrap(PostProcessor(cfg)))


def train_loader(cfg, root: str, seed: int):
    """The KITTI training set under ``root`` (flip augmentation as the
    config says) and its threaded loader with the config's workers."""
    dataset = KITTIDataset(cfg, root, is_train=True, seed=seed)
    return dataset, make_train_loader(cfg, dataset, seed=seed % 2 ** 31)


@torch.no_grad()
def first_moments(optimizer, m: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Adam's first moment of every parameter, by name (after one step it
    is (1 - beta1) times the gradient the optimizer received)."""
    state = optimizer.inner.state
    return {n: state[p]["exp_avg"] for n, p in m.named_parameters() if p in state}


def adam_beta1(optimizer) -> float:
    return float(optimizer.inner.param_groups[0]["betas"][0])


_DCN_OPS = ("dcn_forward", "modulated_deform_conv")
_DCN_ORIGINAL = {name: getattr(_dla, name) for name in _DCN_OPS}


def wrap_dcn(wrapper: Callable[[Callable], Callable]) -> Callable[[], None]:
    """Route the model's DCN calls (the op ``models/backbone/dla.py::DCN``
    calls, kernel or plain) through ``wrapper(op)``; returns what undoes
    this one wrapping."""
    before = {name: getattr(_dla, name) for name in _DCN_OPS}
    for name, op in before.items():
        setattr(_dla, name, wrapper(op))

    def undo():
        for name, op in before.items():
            setattr(_dla, name, op)
    return undo


def restore_dcn() -> None:
    """The model's DCN calls back on the program's own ops."""
    for name, op in _DCN_ORIGINAL.items():
        setattr(_dla, name, op)
