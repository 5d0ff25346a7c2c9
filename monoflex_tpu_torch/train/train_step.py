"""The training step: forward in train mode, the 11 losses, backward, the
optimizer update and the non-finite guard (counterpart of
``monoflex_tpu/train/train_step.py``).

The JAX step is one pure function of a TrainState.  Here the parameters and
BN running stats live in the model and the moments in the optimizer, which
the step updates in place; ``TrainState`` keeps the two counters.  A
non-finite total skips the update as in JAX: parameters, moments, the LR
schedule's count, the EMA and the BN running stats (which torch has already
moved during the forward, so they are restored) stay as before the step,
while ``step`` and ``skips`` advance.  Deciding that costs one host sync per
step, on the total loss.  ``make_eval_step`` is the evaluation path's
forward and decode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .solver import Optimizer

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrainState:
    step: int = 0
    skips: int = 0     # consecutive non-finite steps


def forward_backward(model: nn.Module, loss_computer, batch: Tensors
                     ) -> Tuple[torch.Tensor, Tensors, Tensors]:
    """Train-mode forward, the losses, and the gradient of their sum left in
    each parameter's ``.grad``: (total, loss_dict, log_dict)."""
    model.train()
    for p in model.parameters():
        p.grad = None
    outputs = model(batch["image"], batch.get("edge_indices"), batch.get("edge_len"))
    loss_dict, log_dict = loss_computer(outputs, batch)
    # summed in the order of jax.tree.leaves (sorted keys)
    total = sum(loss_dict[k] for k in sorted(loss_dict))
    total.backward()
    return total.detach(), loss_dict, log_dict


def make_train_step(model: nn.Module, loss_computer, optimizer: Optimizer
                    ) -> Callable[[TrainState, Tensors], Tuple[TrainState, Dict[str, object]]]:
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch: Tensors) -> Tuple[TrainState, Dict[str, object]]:
        buffers = [b for _, b in model.named_buffers()]
        saved = [b.clone() for b in buffers]
        total, _, log_dict = forward_backward(model, loss_computer, batch)
        finite = bool(torch.isfinite(total))
        if finite:
            optimizer.step()
        else:
            with torch.no_grad():
                for b, old in zip(buffers, saved):
                    b.copy_(old)
        skips = 0 if finite else state.skips + 1
        metrics = {"total_loss": total, "skipped": float(not finite),
                   "consecutive_skips": float(skips),
                   **{k: v.detach() for k, v in log_dict.items()}}
        return TrainState(step=state.step + 1, skips=skips), metrics

    return train_step


def make_eval_step(model: nn.Module, post_processor
                   ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]]:
    """Returns eval_step(batch, output_depth=None) -> (rows (B, K, 14),
    valid (B, K), extras): the model in eval mode under
    ``torch.inference_mode``, then the decode.  ``batch`` holds tensors on
    the model's device."""

    def eval_step(batch: Tensors, output_depth: Optional[str] = None):
        model.eval()
        with torch.inference_mode():
            outputs = model(batch["image"], batch.get("edge_indices"), batch.get("edge_len"))
            return post_processor(outputs, batch, output_depth=output_depth)

    return eval_step
