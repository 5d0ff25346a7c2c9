"""The eval forward as CUDA graphs, one per input signature.

``GraphedForward(model)(image, edge_indices, edge_len)`` puts ``model`` in
eval mode and returns what ``model(image, edge_indices, edge_len)``
returns.  On the card, the forward is a chain of some 700 small launches
(cuDNN convolutions, BN, activations, the 16 ``dcn_fwd`` launches and their
weight layouts, the head towers) that the host issues more slowly than the
card runs them.  A
captured ``torch.cuda.CUDAGraph`` issues the same kernels with the same
launch parameters from one host call, so its results are bit-equal to the
eager forward's.

A call is graphable when it runs under ``torch.inference_mode`` on inputs
on one CUDA device, and no module has a forward hook (a replay runs no
Python).  Its signature is the
shape and dtype of the three inputs (None for an absent edge input), their
device, the ``spec`` of every ``DCN`` module (a guard's reroute or
``set_dcn_specs`` recaptures) and the address of every parameter and
buffer: a tensor replaced instead of written in place gives a new key, so
a graph never reads freed memory, while weights written in place (an
optimizer step, ``ema_params``, ``load_state_dict``) are what the next
replay reads.  The key leaves out the modules' other attributes and torch's
global flags (precision, cuDNN): a replay runs the kernels the capture
chose, so a forward whose code path those change needs a new
``GraphedForward``.

The first call of a signature runs eagerly (cuDNN's autotune picks its
algorithms there).  The second warms up on a side stream, copies the
inputs into static buffers, captures into the graph's private memory pool
(all the forward's scratch, ``dcn_fwd``'s weight image and output
included) and replays; later calls copy the inputs in and replay.  The
outputs are the graph's own tensors, rewritten by the next replay, so a
caller keeps none of them (``own`` copies what it returns).  A capture
that raises (an op that waits for the card) leaves that signature eager,
counted in ``eval_step.graph_fallbacks`` and logged once.  At most
``MAX_GRAPHS`` signatures are kept, the least recently used dropped first:
a KITTI evaluation needs two (the batch and the last, shorter one).

Counters (``utils/trace.py``): ``eval_step.graph_captures``,
``.graph_replays`` (the capture's own replay included) and
``.graph_fallbacks``.  The DCN wrappers' launch counters
(``ops/dcn_cuda.py``) count one forward's launches per call as in eager
mode: the warm-up and the capture are left out, and each replay adds what
the capture launched.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Tuple

import torch
from torch import nn
from torch.nn.modules import module as _module

from ..models.backbone.dla import DCN
from ..ops import dcn_cuda
from ..utils import trace

MAX_GRAPHS = 4
_WRAPPERS = (dcn_cuda.dcn_forward, dcn_cuda.dcn_forward_bn_relu, dcn_cuda.dcn_bwd_dx,
             dcn_cuda.dcn_bwd_dwmo)
_COUNTERS = ("launches", "bf16_math_launches")
_EAGER = "eager"      # a signature whose capture failed
_SEEN = "seen"        # a signature run once, eagerly

logger = logging.getLogger("monoflex.eval_graph")

Inputs = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def _launch_counts() -> Dict[Tuple[object, str], int]:
    return {(f, c): getattr(f, c) for f in _WRAPPERS for c in _COUNTERS if hasattr(f, c)}


def _set_launch_counts(counts: Dict[Tuple[object, str], int]) -> None:
    for (f, c), n in counts.items():
        setattr(f, c, n)


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors of a nest of dicts, tuples and lists."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = obj.values()
    elif not isinstance(obj, (tuple, list)):
        return []
    return [t for v in obj for t in _tensors(v)]


def _walk(model: nn.Module, backward: bool = False
          ) -> Optional[Tuple[bool, bool, tuple, tuple]]:
    """One pass over ``model``'s modules, made on every call (written for
    speed: ``model.modules()`` alone takes twice as long): whether any module
    is in training mode, whether every module is, the DCN specs and the
    addresses of the parameters and buffers; None where a module has a
    forward hook (its Python must run on every call) or, with ``backward``,
    a backward hook, or a parameter a gradient hook."""
    if _module._global_forward_hooks or _module._global_forward_pre_hooks:
        return None
    if backward and (_module._global_backward_hooks or _module._global_backward_pre_hooks):
        return None
    any_training, all_training = False, True
    ptrs: List[int] = []
    specs = []
    stack = [model]
    pop, push, add = stack.pop, stack.extend, ptrs.append
    while stack:
        m = pop()
        if m is None:
            continue
        d = m.__dict__
        if d["_forward_hooks"] or d["_forward_pre_hooks"]:
            return None
        if backward and (d["_backward_hooks"] or d["_backward_pre_hooks"]):
            return None
        if d["training"]:
            any_training = True
        else:
            all_training = False
        for t in d["_parameters"].values():
            if t is not None:
                if backward and (t._backward_hooks or t._post_accumulate_grad_hooks):
                    return None
                add(t.data_ptr())
        for t in d["_buffers"].values():
            if t is not None:
                add(t.data_ptr())
        push(d["_modules"].values())
        if isinstance(m, DCN):
            specs.append(m.spec)
    return any_training, all_training, tuple(specs), tuple(ptrs)


def _key(inputs: Inputs, specs: tuple, ptrs: tuple) -> Hashable:
    shapes = tuple(None if t is None else (tuple(t.shape), t.dtype) for t in inputs)
    return shapes, inputs[0].device, specs, ptrs


def signature(model: nn.Module, inputs: Inputs) -> Optional[Hashable]:
    """The key of a forward of ``model`` on ``inputs``; None where a module
    has a forward hook."""
    walked = _walk(model)
    return None if walked is None else _key(inputs, *walked[2:])


def graphable(inputs: Inputs) -> bool:
    """Whether a forward on ``inputs`` may run as a CUDA graph: under
    inference mode, the inputs on one card (a model elsewhere fails its
    first, eager, call)."""
    device = inputs[0].device
    if device.type != "cuda" or not torch.is_inference_mode_enabled():
        return False
    return all(t is None or t.device == device for t in inputs[1:])


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    static: Tuple[Optional[torch.Tensor], ...]     # the inputs the graph reads
    outputs: object                                # the model's outputs, the graph's tensors
    storages: frozenset                            # their storages' addresses
    launches: Dict[Tuple[object, str], int]        # DCN launches of one forward


class GraphedForward:
    """``model``'s forward in eval mode, replayed from a CUDA graph per
    signature where the call is graphable, eager otherwise (module
    docstring)."""

    def __init__(self, model: nn.Module):
        self.model = model
        self.graphs: "OrderedDict[Hashable, object]" = OrderedDict()
        self._stream: Optional[torch.cuda.Stream] = None
        self._warned = False
        self._last: frozenset = frozenset()   # storages of the last call's outputs, if a graph's

    def __call__(self, image: torch.Tensor, edge_indices: Optional[torch.Tensor] = None,
                 edge_len: Optional[torch.Tensor] = None):
        inputs = (image, edge_indices, edge_len)
        self._last = frozenset()
        walked = _walk(self.model) if graphable(inputs) else None
        if walked is None:
            self.model.eval()
            return self.model(*inputs)
        training, _, specs, ptrs = walked
        if training:
            # eval() sets every module's flag through nn.Module.__setattr__:
            # 1-2 ms of host time, spent only where a flag is set
            self.model.eval()
        key = _key(inputs, specs, ptrs)
        entry = self.graphs.get(key)
        if entry is None:
            self._keep(key, _SEEN)
            return self.model(*inputs)
        self.graphs.move_to_end(key)
        if entry is _EAGER:
            return self.model(*inputs)
        if entry is _SEEN:
            entry = self._capture(key, inputs)
            if entry is None:
                return self.model(*inputs)
        return self._replay(entry, inputs)

    def own(self, *results):
        """``results`` with every tensor (or dict value) that shares storage
        with the last call's outputs, where a graph replayed them, copied out
        of it."""
        if not self._last:
            return results

        def fresh(t):
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() in self._last:
                return t.clone()
            return t
        return tuple({k: fresh(v) for k, v in r.items()} if isinstance(r, dict) else fresh(r)
                     for r in results)

    def _keep(self, key: Hashable, entry: object) -> None:
        self.graphs[key] = entry
        self.graphs.move_to_end(key)
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)

    def _capture(self, key: Hashable, inputs: Inputs) -> Optional[_Graph]:
        device = inputs[0].device
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        stream = self._stream
        before = _launch_counts()
        try:
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                self.model(*inputs)
            torch.cuda.current_stream(device).wait_stream(stream)
            static = tuple(None if t is None else torch.empty_like(t) for t in inputs)
            warm = _launch_counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                outputs = self.model(*static)
        except RuntimeError as e:
            _set_launch_counts(before)
            self._keep(key, _EAGER)
            trace.add("eval_step.graph_fallbacks")
            if not self._warned:
                self._warned = True
                logger.warning(f"the eval forward runs eagerly at input signature "
                               f"{key[0]}: its CUDA graph capture failed ({e})")
            return None
        launches = {k: n - warm[k] for k, n in _launch_counts().items()}
        _set_launch_counts(before)
        entry = _Graph(graph, static, outputs,
                       frozenset(t.untyped_storage().data_ptr() for t in _tensors(outputs)),
                       launches)
        self._keep(key, entry)
        trace.add("eval_step.graph_captures")
        return entry

    def _replay(self, entry: _Graph, inputs: Inputs):
        for buf, t in zip(entry.static, inputs):
            if buf is not None:
                buf.copy_(t)
        entry.graph.replay()
        for (f, c), n in entry.launches.items():
            if n:
                setattr(f, c, getattr(f, c) + n)
        trace.add("eval_step.graph_replays")
        self._last = entry.storages
        return entry.outputs
