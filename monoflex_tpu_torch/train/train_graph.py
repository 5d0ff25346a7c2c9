"""The training step as CUDA graphs, one per batch signature.

``TrainGraphs(model, loss_computer, optimizer, eager)(state, batch)``
returns what the eager step ``eager(state, batch)`` returns
(``train_step.py``).  On the card an eager step is a few thousand launches
(the train-mode forward, the 11 losses, autograd's backward, AdamW), which
the host issues barely faster than the card runs them.  One captured
``torch.cuda.CUDAGraph`` holds the whole step: a copy of the state a
skipped step restores (the parameters, the moments, the EMA shadows and the
buffers), the forward, the losses and their sum, the backward, the zero
gradients of the parameters the loss does not reach and the clip
(``Optimizer.prepare_gradients``), ``ok = isfinite(total)``, and the
update with the EMA (``solver.DeviceUpdate``: torch's foreach AdamW with
every value that changes from step to step read from a device tensor).  A
later call copies the batch into the graph's inputs, writes the step's
values, replays and reads ``ok``: the step's one host sync, after all of it
is enqueued.  A taken step moves the host's counters
(``DeviceUpdate.commit``); a skipped one copies the state back and moves
none, so the JAX semantics of the eager step hold: parameters, moments,
the EMA, the BN buffers, ``Optimizer.count`` and the schedule stay, while
``TrainState.step`` and ``skips`` advance.  The forward, the losses and the
backward run the eager step's kernels, so a replayed step is bit-equal to
an eager one.

A call is graphable when the batch is on one CUDA device, the step runs in
one process (no ``DistributedDataParallel``), no module has a hook (forward
or backward) nor a parameter a gradient hook, and ``DeviceUpdate`` takes
the optimizer (``solver.device_update_refusal``) and finds its moments.
Otherwise it runs eagerly; an optimizer that ``DeviceUpdate`` refuses is
counted in ``train_step.graph_fallbacks`` and logged once.  The signature
is the shapes and dtypes of the batch, the DCN specs (``eval_graph.py``),
the addresses of the parameters, buffers, moments and EMA shadows, and
what the graph bakes in (betas, eps, weight decay, the clip): a tensor
replaced, not written in place, recaptures, while an EMA swap or a model's
``load_state_dict`` replays.

The first call of a signature runs eagerly (cuDNN's autotune, the moments'
allocation, the loss's device tables), and the signature is taken after it
(the moments' addresses appear in the first step).
The second captures on a side stream and replays; later calls replay.  A
capture that raises (an op that waits for the card) leaves that signature
eager, counted in ``train_step.graph_fallbacks`` and logged once.  At most
``MAX_GRAPHS`` signatures are kept, the least recently used dropped first
(a graph's memory pool holds one step's activations).

Spans (``utils/trace.py``): a replayed step records ``train_step.forward``
around the whole call that issues the graph (input copies, values, replay),
``train_step.finite_sync`` around the read of ``ok`` and, on a skip,
``train_step.restore``; a capture is ``train_step.capture``.  The spans
``.snapshot``, ``.loss``, ``.backward`` and ``.optimizer`` are not
recorded, their work being inside the graph.  Counters:
``train_step.graph_captures``, ``.graph_replays`` (the capture's own replay
included) and ``.graph_fallbacks``; the DCN wrappers' launch counters add
one step's launches per replay.  Returned metrics are copies: the next
replay rewrites the graph's tensors.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..utils import comm, trace
from .eval_graph import _EAGER, _SEEN, _launch_counts, _set_launch_counts, _walk
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
    walked = _walk(model, backward=True)
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
class _Graph:
    graph: torch.cuda.CUDAGraph
    static: Tensors                        # the batch the graph reads
    update: DeviceUpdate
    state: List[List[torch.Tensor]]        # what a skip restores, by dtype
    saved: List[List[torch.Tensor]]        # its copy, taken at the start of the step
    ok: torch.Tensor                       # isfinite(total)
    keys: Tuple[str, ...]                  # total_loss, then the log entries
    values: List[torch.Tensor]             # the graph's tensors of those
    params: List[nn.Parameter]
    grads: List[torch.Tensor]              # the graph's gradients
    launches: Dict[Tuple[object, str], int]


class TrainGraphs:
    """``eager``'s training step, replayed from a CUDA graph per signature
    where the call is graphable (module docstring)."""

    def __init__(self, model: nn.Module, loss_computer, optimizer: Optimizer,
                 eager: Callable):
        self.model = model
        self.loss_computer = loss_computer
        self.optimizer = optimizer
        self.eager = eager
        self.graphs: "OrderedDict[Hashable, object]" = OrderedDict()
        self._stream: Optional[torch.cuda.Stream] = None
        self._refused: Optional[str] = None    # the refusal logged last
        self._warned = False
        self._all_training = False             # of the last signature's walk

    def __call__(self, state, batch: Tensors):
        key = self.signature(batch)
        entry = None if key is None else self.graphs.get(key)
        if entry is None:
            out = self.eager(state, batch)
            # the signature the next call will have: the first step makes
            # the moments, which have none before it
            after = self.signature(batch)
            if after is not None and after not in self.graphs:
                self._keep(after, _SEEN)
            return out
        self.graphs.move_to_end(key)
        if entry is _EAGER:
            return self.eager(state, batch)
        if entry is _SEEN:
            with trace.span("train_step.capture"):
                entry = self._capture(key, batch)
            if entry is None:
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
                trace.add("train_step.graph_fallbacks")
                logger.warning(f"the train step runs eagerly: its optimizer has no device "
                               f"update ({refusal})")
            return None
        signed = _signature(self.model, self.optimizer, batch)
        if signed is None:
            return None
        key, self._all_training = signed
        return key

    def _keep(self, key: Hashable, entry: object) -> None:
        self.graphs[key] = entry
        self.graphs.move_to_end(key)
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)

    def _fail(self, key: Hashable, error: Exception) -> None:
        self._keep(key, _EAGER)
        trace.add("train_step.graph_fallbacks")
        if not self._warned:
            self._warned = True
            logger.warning(f"the train step runs eagerly at batch signature {key[0]}: its "
                           f"CUDA graph capture failed ({error})")

    def _capture(self, key: Hashable, batch: Tensors) -> Optional[_Graph]:
        model, opt = self.model, self.optimizer
        device = batch["image"].device
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        try:
            update = DeviceUpdate(opt)
        except ValueError as e:
            self._fail(key, e)
            return None
        state = _by_dtype(update.state() + [b for b in model.buffers()])
        with torch.no_grad():
            # no autograd node may outlive this call: one made here would
            # keep the parameters' gradient accumulators on this stream
            saved = [[t.clone() for t in ts] for ts in state]
        static = {k: t.clone() for k, t in batch.items()}
        params = list(model.parameters())
        for p in params:
            p.grad = None
        model.train()
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
                with torch.no_grad():
                    for dst, src in zip(saved, state):
                        torch._foreach_copy_(dst, src)
                outputs = model(static["image"], static.get("edge_indices"),
                                static.get("edge_len"))
                loss_dict, log_dict = self.loss_computer(outputs, static)
                total = sum(loss_dict[k] for k in sorted(loss_dict))
                total.backward()
                with torch.no_grad():
                    opt.prepare_gradients()
                    ok = torch.isfinite(total)
                    update.apply()
                del outputs, loss_dict
        except RuntimeError as e:
            _set_launch_counts(before)
            for p in params:
                p.grad = None
            self._fail(key, e)
            return None
        launches = {k: n - before[k] for k, n in _launch_counts().items()}
        _set_launch_counts(before)
        keys = ("total_loss", *log_dict)
        values = [total.detach(), *(v.detach() for v in log_dict.values())]
        entry = _Graph(graph, static, update, state, saved, ok, keys, values, params,
                       [p.grad for p in params], launches)
        self._keep(key, entry)
        trace.add("train_step.graph_captures")
        return entry

    def _issue(self, entry: _Graph, batch: Tensors) -> None:
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
        entry.graph.replay()
        for (f, c), n in entry.launches.items():
            if n:
                setattr(f, c, getattr(f, c) + n)
        trace.add("train_step.graph_replays")

    def _finish(self, entry: _Graph, state) -> Tuple[object, Dict[str, object]]:
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
