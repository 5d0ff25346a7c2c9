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

On the card, in one process, the step replays one CUDA graph per batch
signature (``train_graph.py`` through ``graphs.py``); the eager step below
runs on the CPU, under data parallelism, on a signature's first call and
wherever a capture fails.  Its spans (``utils/trace.py``) are
``train_step.snapshot`` (the BN buffers' copy), ``.forward``, ``.loss``,
``.backward``, ``.finite_sync`` (the host waits for the total),
``.optimizer`` or, on a skipped step, ``.restore``; with more than one
process ``.all_reduce``.  A replayed step's are ``train_graph.py``'s.  The
eval step's spans are ``eval_step.forward`` and ``eval_step.decode``; its
forward replays graphs too (``eval_graph.py``).

With more than one process (``model`` wrapped by ``parallel/mesh.py``) the
losses are the processes' shares of the global batch's (``losses/``); one
all-reduce on the device turns the total and the log entries into the
global ones, so every process takes or skips the update together, on the
same number, and restores its BN buffers together.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.detector import require_trainable
from ..utils import comm
from ..utils.precision import apply_precision
from ..utils.trace import span
from .eval_graph import GraphedForward
from .solver import Optimizer
from .train_graph import TrainGraphs

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrainState:
    step: int = 0
    skips: int = 0     # consecutive non-finite steps


def forward_backward(model: nn.Module, loss_computer, batch: Tensors
                     ) -> Tuple[torch.Tensor, Tensors, Tensors]:
    """Train-mode forward, the losses, and the gradient of their sum left in
    each parameter's ``.grad``: (total, loss_dict, log_dict)."""
    with span("train_step.forward"):
        model.train()
        for p in model.parameters():
            p.grad = None
        outputs = model(batch["image"], batch.get("edge_indices"), batch.get("edge_len"))
    with span("train_step.loss"):
        loss_dict, log_dict = loss_computer(outputs, batch)
        # summed in the order of jax.tree.leaves (sorted keys)
        total = sum(loss_dict[k] for k in sorted(loss_dict))
    with span("train_step.backward"):
        total.backward()
    return total.detach(), loss_dict, log_dict


def use_model_precision(model: nn.Module) -> None:
    """Apply the precision flags ``build_model`` resolved for ``model``
    (or for the module a DistributedDataParallel wraps) from its config (a
    model built elsewhere keeps the flags as they are)."""
    precision = getattr(getattr(model, "module", model), "precision", None)
    if precision is not None:
        apply_precision(precision)


def make_train_step(model: nn.Module, loss_computer, optimizer: Optimizer
                    ) -> Callable[[TrainState, Tensors], Tuple[TrainState, Dict[str, object]]]:
    """Returns train_step(state, batch) -> (state, metrics), under the
    precision flags of ``model``'s config, replayed from CUDA graphs where it
    can be (``train_graph.py``); raises for a model whose training is not
    ported (FCOSMono3D)."""
    require_trainable(getattr(getattr(model, "module", model), "arch", "MonoFlex"))
    use_model_precision(model)

    def eager_step(state: TrainState, batch: Tensors) -> Tuple[TrainState, Dict[str, object]]:
        with span("train_step.snapshot"):
            buffers = [b for _, b in model.named_buffers()]
            saved = [b.clone() for b in buffers]
        total, _, log_dict = forward_backward(model, loss_computer, batch)
        log_dict = {k: v.detach() for k, v in log_dict.items()}
        world = comm.get_world_size()
        if world > 1:
            with span("train_step.all_reduce"):
                keys = sorted(log_dict)
                values = torch.stack([total, *(log_dict[k] for k in keys)])
                dist.all_reduce(values)
                values /= world
                total, log_dict = values[0], dict(zip(keys, values[1:]))
        with span("train_step.finite_sync"):
            finite = bool(torch.isfinite(total))
        if finite:
            with span("train_step.optimizer"):
                optimizer.step()
        else:
            with span("train_step.restore"), torch.no_grad():
                for b, old in zip(buffers, saved):
                    b.copy_(old)
        skips = 0 if finite else state.skips + 1
        metrics = {"total_loss": total, "skipped": float(not finite),
                   "consecutive_skips": float(skips), **log_dict}
        return TrainState(step=state.step + 1, skips=skips), metrics

    return TrainGraphs(model, loss_computer, optimizer, eager_step)


def make_eval_step(model: nn.Module, post_processor
                   ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]]:
    """Returns eval_step(batch, output_depth=None) -> (rows (B, K, D),
    valid (B, K), extras): the model in eval mode under
    ``torch.inference_mode``, then the decode, whose rows are its own: D = 14
    and K = TEST.DETECTIONS_PER_IMG from ``PostProcessor``, D = ``ROW`` (12)
    and K = ``MAX_PER_IMG`` (200) from ``decode/fcos3d.py::FCOS3DDecoder``,
    D = 11 and K = 300 from ``decode/bevformer.py::BEVFormerDecoder``
    (``decode/postprocessor.py::build_postprocessor`` picks the config's).
    The forward takes the model's ``graph_inputs(batch)``.  ``batch`` holds tensors on the model's device.  On the card the forward replays a CUDA graph per
    input signature (``eval_graph.py``); nothing returned shares its memory.
    The precision flags of ``model``'s config are applied here."""
    use_model_precision(model)
    forward = GraphedForward(model)
    graph_inputs = getattr(model, "graph_inputs", None) or (
        lambda b: (b["image"], b.get("edge_indices"), b.get("edge_len")))

    def eval_step(batch: Tensors, output_depth: Optional[str] = None):
        with torch.inference_mode():
            with span("eval_step.forward"):
                outputs = forward(*graph_inputs(batch))
            with span("eval_step.decode"):
                return forward.own(*post_processor(outputs, batch, output_depth=output_depth))

    return eval_step
