"""Cross-process communication on torch.distributed (counterpart of
``monoflex_tpu/utils/comm.py``; reference: utils/comm.py:20-264).

Every helper is a no-op or an identity while no process group is up, so
one process runs the same code with no group at all.  Tensors go through
the group's backend on the device it serves: NCCL on the card, gloo on the
CPU.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def _nccl() -> bool:
    return dist.get_backend() == dist.Backend.NCCL


def _device() -> torch.device:
    """The device the group's collectives take tensors on."""
    return torch.device("cuda", torch.cuda.current_device()) if _nccl() else torch.device("cpu")


def synchronize(name: str = "barrier") -> None:
    """Barrier over every process (``name`` labels it, as in the JAX
    package; torch's barrier has no name)."""
    if get_world_size() > 1:
        if _nccl():
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def coordination_barrier(name: str, timeout_s: int = 3600) -> None:
    """A barrier with a timeout of its own: gloo's ``monitored_barrier``,
    which names the ranks that did not arrive; on NCCL a barrier under the
    process group's timeout."""
    if get_world_size() == 1:
        return
    if _nccl():
        synchronize(name)
    else:
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))


def broadcast_object(obj: Any, root: int = 0) -> Any:
    """A picklable object from the root process to all."""
    if get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root, device=_device())
    return box[0]


def all_gather_objects(obj: Any) -> List[Any]:
    """A picklable object from every process, in rank order."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def reduce_dict(metrics: Dict[str, float], average: bool = True) -> Dict[str, float]:
    """Scalar metrics summed (or averaged) over processes, on the host."""
    if get_world_size() == 1:
        return metrics
    keys = sorted(metrics)
    vec = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64, device=_device())
    dist.all_reduce(vec)
    if average:
        vec /= get_world_size()
    return dict(zip(keys, vec.tolist()))


def shared_random_seed() -> int:
    """One seed agreed across processes (reference: utils/comm.py:221-232)."""
    return int(broadcast_object(np.random.randint(2 ** 31)))


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every process, on its device, without a gradient
    and without a host sync; ``t`` itself in one process."""
    if get_world_size() == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def global_max(t: torch.Tensor) -> torch.Tensor:
    """The largest value of the scalar ``t`` over every process, with the
    gradient of a max: every process's gradient flows into the process (or
    the processes, shared) that holds the maximum.  ``t`` in one process."""
    if get_world_size() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    top = t.detach().clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX)
    holds = (t.detach() == top).to(t.dtype)
    return all_reduce(holds * t) / global_sum(holds)
