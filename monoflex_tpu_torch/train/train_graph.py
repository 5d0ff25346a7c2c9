"""The training step as CUDA graphs, one per batch signature (the shared
rules are ``graphs.py``'s).

``TrainGraphs(model, loss_computer, optimizer, eager)(state, batch)``
returns what the eager step ``eager(state, batch)`` returns
(``train_step.py``), whose few thousand launches the host issues barely
faster than the card runs them.  One graph holds the whole step: a copy of
what a skip restores (parameters, moments, EMA shadows, buffers), the
forward, the losses, the backward, ``Optimizer.prepare_gradients``,
``ok = isfinite(total)`` and the update with the EMA
(``solver.DeviceUpdate``: torch's foreach AdamW with every per-step value
read from a device tensor).  A replay copies the batch in, writes the
step's values, replays and reads ``ok``, its one host sync.  A taken step
moves the host's counters (``DeviceUpdate.commit``); a skipped one copies
the state back and moves none, as the eager step does.

A call is graphable when the batch is on one CUDA device, in one process
(no ``DistributedDataParallel``), with no hook on a module (forward or
backward) or parameter, and an optimizer ``DeviceUpdate`` takes
(``solver.device_update_refusal``; a refusal counts in
``train_step.graph_fallbacks``, logged once).  Its signature adds the
moments' and EMA shadows' addresses and what the graph bakes in (betas,
eps, weight decay, the clip), and is taken after the signature's first,
eager, step, which makes the moments.  ``MAX_GRAPHS`` are kept (a graph's
pool holds one step's activations).

Spans (``utils/trace.py``): a replayed step records ``train_step.forward``
around issuing the graph (input copies, values, replay),
``.finite_sync`` around the read of ``ok`` and, on a skip, ``.restore``; a
capture is ``train_step.capture``.  Counters: ``train_step.graph_*``.
Returned metrics are copies: the next replay rewrites the graph's tensors.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..utils import comm, trace
from .graphs import EAGER, SEEN, Graph, GraphCache, walk
from .solver import DeviceUpdate, Optimizer, device_update_refusal

MAX_GRAPHS = 2

logger = logging.getLogger("monoflex.train_graph")

Tensors = Dict[str, torch.Tensor]


def _by_dtype(tensors: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def graphable(model: nn.Module, batch: Tensors) -> bool:
    """Whether a step of ``model`` on ``batch`` may replay a graph: the
    batch on one card, one process, no DistributedDataParallel wrapper."""
    device = batch["image"].device
    return (device.type == "cuda" and not isinstance(model, DistributedDataParallel)
            and comm.get_world_size() == 1
            and all(t.device == device for t in batch.values()))


def _signature(model: nn.Module, opt: Optimizer, batch: Tensors
               ) -> Optional[Tuple[Hashable, bool]]:
    """(the key, whether every module is in training mode); None where a
    module or a parameter has a hook, or a parameter has no moments yet."""
    walked = walk(model, backward=True)
    if walked is None:
        return None
    _, all_training, specs, ptrs = walked
    state = opt.inner.state
    moments = []
    for group in opt.inner.param_groups:
        for p in group["params"]:
            s = state.get(p)
            if not s or "exp_avg" not in s:
                return None
            moments.append((s["exp_avg"].data_ptr(), s["exp_avg_sq"].data_ptr()))
    baked = (opt.grad_clip, opt.ema is not None,
             tuple((g["betas"][1], g["betas"][0] if opt.momentum is None else None,
                    g["eps"], g["weight_decay"], len(g["params"]))
                   for g in opt.inner.param_groups))
    shadows = () if opt.ema is None else tuple(t.data_ptr() for t in opt.ema.shadow.values())
    shapes = tuple((k, tuple(t.shape), t.dtype) for k, t in sorted(batch.items()))
    return (shapes, batch["image"].device, specs, ptrs, tuple(moments), shadows,
            baked), all_training


def signature(model: nn.Module, optimizer: Optimizer, batch: Tensors) -> Optional[Hashable]:
    """The key a step of ``model`` and ``optimizer`` on ``batch`` is kept
    under; None where a module or a parameter has a hook, or a parameter
    has no moments yet (before the first step)."""
    signed = _signature(model, optimizer, batch)
    return None if signed is None else signed[0]


@dataclass
class _Step(Graph):
    static: Tensors                        # the batch the graph reads
    update: DeviceUpdate
    state: List[List[torch.Tensor]]        # what a skip restores, by dtype
    saved: List[List[torch.Tensor]]        # its copy, taken at the start of the step
    ok: torch.Tensor                       # isfinite(total)
    keys: Tuple[str, ...]                  # total_loss, then the log entries
    values: List[torch.Tensor]             # the graph's tensors of those
    params: List[nn.Parameter]
    grads: List[torch.Tensor]              # the graph's gradients


class TrainGraphs:
    """``eager``'s training step, replayed from a CUDA graph per signature
    where the call is graphable (module docstring)."""

    def __init__(self, model: nn.Module, loss_computer, optimizer: Optimizer,
                 eager: Callable):
        self.model = model
        self.loss_computer = loss_computer
        self.optimizer = optimizer
        self.eager = eager
        self.cache = GraphCache("train_step", MAX_GRAPHS, logger)
        self._refused: Optional[str] = None    # the refusal logged last
        self._all_training = False             # of the last signature's walk

    def __call__(self, state, batch: Tensors):
        key = self.signature(batch)
        entry = self.cache.get(key)
        if entry is SEEN:
            with trace.span("train_step.capture"):
                entry = self.cache.capture(key, batch["image"].device, self._prepare,
                                           self._record, batch)
        if entry is None:
            out = self.eager(state, batch)
            # the signature the next call will have: the first step makes
            # the moments, which have none before it
            self.cache.seen(self.signature(batch))
            return out
        if entry is EAGER:
            return self.eager(state, batch)
        with trace.span("train_step.forward"):
            self._issue(entry, batch)
        return self._finish(entry, state)

    def signature(self, batch: Tensors) -> Optional[Hashable]:
        """The key of a step on ``batch``; None where the step runs eagerly."""
        if not graphable(self.model, batch):
            return None
        refusal = device_update_refusal(self.optimizer)
        if refusal is not None:
            if refusal != self._refused:
                self._refused = refusal
                self.cache.fall_back(None, f"its optimizer has no device update ({refusal})")
            return None
        signed = _signature(self.model, self.optimizer, batch)
        if signed is None:
            return None
        key, self._all_training = signed
        return key

    def _prepare(self, stream: torch.cuda.Stream, batch: Tensors) -> tuple:
        """What the capture needs, made before it."""
        update = DeviceUpdate(self.optimizer)
        state = _by_dtype(update.state() + [b for b in self.model.buffers()])
        with torch.no_grad():
            # no autograd node may outlive this call: one made here would
            # keep the parameters' gradient accumulators on this stream
            saved = [[t.clone() for t in ts] for ts in state]
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        self.model.train()
        return {k: t.clone() for k, t in batch.items()}, update, state, saved, params

    def _record(self, prepared: tuple) -> _Step:
        static, update, state, saved, params = prepared
        with torch.no_grad():
            for dst, src in zip(saved, state):
                torch._foreach_copy_(dst, src)
        outputs = self.model(static["image"], static.get("edge_indices"),
                             static.get("edge_len"))
        loss_dict, log_dict = self.loss_computer(outputs, static)
        total = sum(loss_dict[k] for k in sorted(loss_dict))
        total.backward()
        with torch.no_grad():
            self.optimizer.prepare_gradients()
            ok = torch.isfinite(total)
            update.apply()
        return _Step(static, update, state, saved, ok, ("total_loss", *log_dict),
                     [total.detach(), *(v.detach() for v in log_dict.values())], params,
                     [p.grad for p in params])

    def _issue(self, entry: _Step, batch: Tensors) -> None:
        for k, t in entry.static.items():
            t.copy_(batch[k])
        entry.update.write()
        if entry.params[0].grad is not entry.grads[0]:
            for p, g in zip(entry.params, entry.grads):
                p.grad = g
        if not self._all_training:
            # train() sets every module's flag through nn.Module.__setattr__:
            # 1-2 ms of host time, spent only where a flag is set
            self.model.train()
        self.cache.replay(entry)

    def _finish(self, entry: _Step, state) -> Tuple[object, Dict[str, object]]:
        owned = torch.stack(entry.values).unbind() if len({v.dtype for v in entry.values}) == 1 \
            else [v.clone() for v in entry.values]
        with trace.span("train_step.finite_sync"):
            finite = bool(entry.ok)
        if finite:
            entry.update.commit()
        else:
            with trace.span("train_step.restore"), torch.no_grad():
                for dst, src in zip(entry.state, entry.saved):
                    torch._foreach_copy_(dst, src)
        skips = 0 if finite else state.skips + 1
        metrics = {"total_loss": owned[0], "skipped": float(not finite),
                   "consecutive_skips": float(skips), **dict(zip(entry.keys[1:], owned[1:]))}
        return type(state)(step=state.step + 1, skips=skips), metrics
