"""The eval forward as CUDA graphs, one per input signature (the shared
rules are ``graphs.py``'s).

``GraphedForward(model)(*inputs)`` puts ``model`` in eval mode and returns
what ``model(*inputs)`` returns: MonoFlex and FCOS3D take (image,
edge_indices, edge_len), BEVFormer (images, lidar2img, can_bus,
scene_start) (each model's ``graph_inputs``).  On the card the forward is a
chain of hundreds of small launches (cuDNN convolutions, BN, activations,
the DCN and deformable-attention kernels, the head towers) that the host
issues more slowly than the card runs them.

A call is graphable when it runs under ``torch.inference_mode`` on inputs
on one CUDA device, and no module has a forward hook.  Its signature is the
shape and dtype of each input (None for an absent one), their device, the
DCN specs and the parameters' and buffers' addresses.  The capture warms up
on the side stream, copies the inputs into static buffers and captures into
the graph's private memory pool (all the forward's scratch, ``dcn_fwd``'s
weight image and output included); a replay copies the inputs in.  State
that a forward reads and overwrites in place (the model's ``carried()``:
BEVFormer's BEV history) is put back after the warm-up, so the call that
captures reads what an eager call would.  The outputs are the graph's own
tensors, rewritten by the next replay, so a caller keeps none of them
(``own`` copies what it returns).  ``MAX_GRAPHS`` signatures are kept: a
KITTI evaluation needs two (the batch and the last, shorter one).
Counters: ``eval_step.graph_*``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Hashable, List, Optional, Tuple

import torch
from torch import nn

from .graphs import EAGER, SEEN, Graph, GraphCache, walk

MAX_GRAPHS = 4

logger = logging.getLogger("monoflex.eval_graph")

Inputs = Tuple[Optional[torch.Tensor], ...]


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors of a nest of dicts, tuples and lists."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = obj.values()
    elif not isinstance(obj, (tuple, list)):
        return []
    return [t for v in obj for t in _tensors(v)]


def _key(inputs: Inputs, specs: tuple, ptrs: tuple) -> Hashable:
    shapes = tuple(None if t is None else (tuple(t.shape), t.dtype) for t in inputs)
    return shapes, inputs[0].device, specs, ptrs


def signature(model: nn.Module, inputs: Inputs) -> Optional[Hashable]:
    """The key of a forward of ``model`` on ``inputs``; None where a module
    has a forward hook."""
    walked = walk(model)
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
class _Forward(Graph):
    static: Tuple[Optional[torch.Tensor], ...]     # the inputs the graph reads
    outputs: object                                # the model's outputs, the graph's tensors
    storages: frozenset                            # their storages' addresses


class GraphedForward:
    """``model``'s forward in eval mode, replayed from a CUDA graph per
    signature where the call is graphable, eager otherwise (module
    docstring)."""

    def __init__(self, model: nn.Module):
        self.model = model
        self.cache = GraphCache("eval_step", MAX_GRAPHS, logger)
        self._last: frozenset = frozenset()   # storages of the last call's outputs, if a graph's

    def __call__(self, *inputs: Optional[torch.Tensor]):
        self._last = frozenset()
        walked = walk(self.model) if graphable(inputs) else None
        if walked is None:
            self.model.eval()
            return self.model(*inputs)
        training, _, specs, ptrs = walked
        if training:
            # eval() sets every module's flag through nn.Module.__setattr__:
            # 1-2 ms of host time, spent only where a flag is set
            self.model.eval()
        key = _key(inputs, specs, ptrs)
        entry = self.cache.get(key)
        if entry is SEEN:
            entry = self.cache.capture(key, inputs[0].device, self._warm_up, self._record,
                                       inputs)
        if entry is None:
            self.cache.seen(key)
        elif entry is not EAGER:
            for buf, t in zip(entry.static, inputs):
                if buf is not None:
                    buf.copy_(t)
            self.cache.replay(entry)
            self._last = entry.storages
            return entry.outputs
        return self.model(*inputs)

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

    def _warm_up(self, stream: torch.cuda.Stream, inputs: Inputs) -> Inputs:
        """One forward on the capture's stream, the carried state put back
        after it; the static inputs."""
        current = torch.cuda.current_stream(inputs[0].device)
        stream.wait_stream(current)
        carried = getattr(self.model, "carried", list)()
        with torch.cuda.stream(stream):
            saved = [t.clone() for t in carried]
            self.model(*inputs)
            for t, old in zip(carried, saved):
                t.copy_(old)
        current.wait_stream(stream)
        return tuple(None if t is None else torch.empty_like(t) for t in inputs)

    def _record(self, static: Inputs) -> _Forward:
        outputs = self.model(*static)
        return _Forward(static, outputs,
                        frozenset(t.untyped_storage().data_ptr() for t in _tensors(outputs)))
