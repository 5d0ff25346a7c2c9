"""CUDA graphs kept per call signature, shared by the eval forward
(``eval_graph.py``) and the training step (``train_graph.py``).

A captured ``torch.cuda.CUDAGraph`` issues the eager call's kernels with
the same launch parameters from one host call: a replay is bit-equal to
the eager call.  It runs no Python, so a call with a hook stays eager
(``walk``).  A call's key, made by its caller, holds its inputs' shapes,
dtypes and device, every ``DCN`` module's ``spec`` (a guard's reroute or
``set_dcn_specs`` recaptures) and the address of every parameter and
buffer: a tensor replaced instead of written in place gives a new key, so a
graph never reads freed memory, while one written in place (an optimizer
step, ``ema_params``, ``load_state_dict``) is what the next replay reads.
The key leaves out the modules' other attributes and torch's global flags
(precision, cuDNN): a replay runs the kernels the capture chose.

``GraphCache``: a signature's first call runs eagerly (cuDNN's autotune
picks its algorithms there), the second captures on a side stream and
replays, later calls replay; at most ``max_graphs`` signatures are kept,
the least recently used dropped first.  A capture that raises a
``RuntimeError`` (an op that waits for the card) or ``ValueError`` (an
optimizer ``DeviceUpdate`` refuses) leaves its signature eager, counted in
``<prefix>.graph_fallbacks`` (the cache's first fallback logged).
Counters (``utils/trace.py``): ``<prefix>.graph_captures``,
``.graph_replays`` (the capture's own included) and ``.graph_fallbacks``.
The kernel wrappers' launch counters (``ops/dcn_cuda.py``, ``ops/msda.py``)
count one call's launches a call, as in eager mode: each replay adds what the capture
launched, and the capture's own launches are taken back.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch
from torch import nn
from torch.nn.modules import module as _module

from ..models.backbone.dla import DCN
from ..ops import dcn_cuda, msda
from ..utils import trace

EAGER = "eager"      # a signature whose capture failed
SEEN = "seen"        # a signature run once, eagerly

_WRAPPERS = (dcn_cuda.dcn_forward, dcn_cuda.dcn_forward_bn_relu, dcn_cuda.dcn_bwd_dx,
             dcn_cuda.dcn_bwd_dwmo, msda.msda_forward)
_COUNTERS = ("launches", "bf16_math_launches", "wide_launches")


def _launch_counts() -> Dict[Tuple[object, str], int]:
    return {(f, c): getattr(f, c) for f in _WRAPPERS for c in _COUNTERS if hasattr(f, c)}


def _set_launch_counts(counts: Dict[Tuple[object, str], int]) -> None:
    for (f, c), n in counts.items():
        setattr(f, c, n)


def walk(model: nn.Module, backward: bool = False
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


class Graph:
    """A captured call as its caller keeps it (a subclass); ``capture`` sets
    ``graph`` and ``launches``, the DCN launches of one call."""
    graph: torch.cuda.CUDAGraph
    launches: Dict[Tuple[object, str], int]


class GraphCache:
    """The signatures of one caller's calls: ``SEEN``, ``EAGER`` or a
    ``Graph``, at most ``max_graphs`` (module docstring).  ``prefix`` names
    the counters; ``logger`` logs the fallbacks."""

    def __init__(self, prefix: str, max_graphs: int, logger: logging.Logger):
        self.prefix, self.max_graphs, self.logger = prefix, max_graphs, logger
        self.graphs: "OrderedDict[Hashable, object]" = OrderedDict()
        self._stream: Optional[torch.cuda.Stream] = None
        self._warned = False
        self._captures, self._replays, self._fallbacks = (
            f"{prefix}.graph_{c}" for c in ("captures", "replays", "fallbacks"))

    def get(self, key: Optional[Hashable]) -> object:
        """What is kept under ``key``, now the most recently used; None for a
        key not kept (or None)."""
        entry = self.graphs.get(key)
        if entry is not None:
            self.graphs.move_to_end(key)
        return entry

    def seen(self, key: Optional[Hashable]) -> None:
        """Marks ``key`` (not None, not kept yet) as run once."""
        if key is not None and key not in self.graphs:
            self._keep(key, SEEN)

    def capture(self, key: Hashable, device: torch.device,
                prepare: Callable[[torch.cuda.Stream, object], object],
                record: Callable[[object], Graph], arg: object) -> object:
        """``record(prepare(stream, arg))``, ``record`` inside a capture on
        ``device``'s side stream, with the launch counters put back after
        both: the ``Graph`` it returns, now kept under ``key``, or ``EAGER``
        where either raised."""
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        before = _launch_counts()
        try:
            prepared = prepare(self._stream, arg)
            graph, start = torch.cuda.CUDAGraph(), _launch_counts()
            with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
                entry = record(prepared)
        except (RuntimeError, ValueError) as e:
            _set_launch_counts(before)
            self.fall_back(key, f"its CUDA graph capture failed ({e})")
            return EAGER
        entry.graph = graph
        entry.launches = {k: n - start[k] for k, n in _launch_counts().items() if n != start[k]}
        _set_launch_counts(before)
        self._keep(key, entry)
        trace.add(self._captures)
        return entry

    def replay(self, entry: Graph) -> None:
        """Replays ``entry`` and counts one call's launches."""
        entry.graph.replay()
        for (f, c), n in entry.launches.items():
            setattr(f, c, getattr(f, c) + n)
        trace.add(self._replays)

    def fall_back(self, key: Optional[Hashable], why: str) -> None:
        """Counts a call that runs eagerly, ``key`` (where not None) eager from
        now on; the cache's first fallback logs ``why``."""
        trace.add(self._fallbacks)
        if key is not None:
            self._keep(key, EAGER)
        if not self._warned:
            self._warned = True
            at = "" if key is None else f" at signature {key[0]}"
            self.logger.warning(f"{self.prefix} runs eagerly{at}: {why}")

    def _keep(self, key: Hashable, entry: object) -> None:
        self.graphs[key] = entry
        self.graphs.move_to_end(key)
        while len(self.graphs) > self.max_graphs:
            self.graphs.popitem(last=False)
