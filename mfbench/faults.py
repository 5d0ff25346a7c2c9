"""Faults planted in the timed path, to show that the check catches them
(``tests/test_mfbench_faults.py``, and ``calibrate.py --faults`` on the
card).  Each wraps the cell's call: a training step
``step(state, batch) -> (state, metrics)`` with its optimizer, or an
evaluation step ``eval_step(batch) -> (rows, valid, extras)``."""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _half(batch: Dict[str, torch.Tensor]) -> int:
    return max(1, batch["image"].shape[0] // 2)


def frozen_state(step: Callable, optimizer) -> Callable:
    """A step that leaves the parameters as they were."""
    optimizer.step = lambda: None
    return step


def train_half_batch(step: Callable, optimizer) -> Callable:
    """Half of the batch left out; the losses are the means over the rest."""
    def faulty(state, batch):
        h = _half(batch)
        return step(state, {k: v[:h] for k, v in batch.items()})
    return faulty


def infer_half_batch(eval_step: Callable) -> Callable:
    """Half of the batch left out; its images get the others' rows."""
    def faulty(batch):
        B, h = batch["image"].shape[0], _half(batch)
        rows, valid, extras = eval_step({k: v[:h] for k, v in batch.items()})
        idx = torch.arange(B, device=rows.device) % h
        return rows[idx], valid[idx], {**extras, "points": extras["points"][idx]}
    return faulty


class _ScaleGrad(torch.autograd.Function):
    """x as it is forward; its gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def dcn_dx_scaled(step: Callable, optimizer) -> Callable:
    """Every DCN's dx made 20% larger where its backward produces it."""
    from . import program

    def wrapper(op):
        return lambda x, *args, **kw: op(_ScaleGrad.apply(x, 1.2), *args, **kw)

    program.wrap_dcn(wrapper)      # undone when the run closes (``program.restore_dcn``)
    return step


def alter_answer(eval_step: Callable) -> Callable:
    """Every detection's depth made 20% larger where the decode produces it."""
    def faulty(batch):
        rows, valid, extras = eval_step(batch)
        rows = rows.clone()
        rows[..., 11] *= 1.2
        return rows, valid, extras
    return faulty


TRAIN = {"frozen_state": frozen_state, "half_batch": train_half_batch,
         "dcn_dx_scaled": dcn_dx_scaled}
INFER = {"half_batch": infer_half_batch, "alter_answer": alter_answer}
