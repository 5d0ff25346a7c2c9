"""Process-group start-up (counterpart of ``monoflex_tpu/engine/launch.py``;
reference: engine/launch.py:23-89).

One process per card.  ``--num_processes``/``--process_id``/
``--coordinator_address`` join this process to a group over hosts (a
``tcp://`` rendezvous at the coordinator); ``--num_chips N`` spawns N local
ranks, one per card, as the reference's launcher does (with the process
flags too: ``num_processes`` hosts of N ranks each).  The backend is NCCL on
cards and gloo under ``MONOFLEX_PLATFORM=cpu``.  One process and no flags
starts no group at all, as in the JAX package.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT = datetime.timedelta(minutes=30)


def on_cpu() -> bool:
    return os.environ.get("MONOFLEX_PLATFORM") == "cpu"


def _free_local_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _init_group(address: str, world_size: int, rank: int, local_rank: int) -> None:
    if not on_cpu():
        torch.cuda.set_device(local_rank)
    dist.init_process_group("gloo" if on_cpu() else "nccl", init_method=f"tcp://{address}",
                            world_size=world_size, rank=rank, timeout=GROUP_TIMEOUT)
    logging.getLogger("monoflex").info(
        f"torch.distributed initialized ({dist.get_backend()}): rank {rank}/{world_size}, "
        f"local rank {local_rank}")


def _run(main_func: Callable, args) -> None:
    try:
        main_func(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _local_worker(local_rank: int, main_func: Callable, address: str, num_chips: int,
                  host: int, world_size: int, args) -> None:
    if on_cpu():
        # ranks on one host share its cores; more threads than cores makes
        # each collective wait for spinning threads of the other ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // num_chips))
    _init_group(address, world_size, host * num_chips + local_rank, local_rank)
    _run(main_func, args)


def launch(main_func: Callable, coordinator_address: Optional[str] = None,
           num_processes: Optional[int] = None, process_id: Optional[int] = None,
           num_chips: Optional[int] = None, *args) -> None:
    """Start the process group the flags ask for and run ``main_func(*args)``
    in each rank (no group without flags)."""
    hosts = num_processes or 1
    host = process_id or 0
    if num_processes is not None and coordinator_address is None:
        raise ValueError("--num_processes needs --coordinator_address (host:port of process 0)")
    if num_chips is not None and num_chips > 1:
        address = coordinator_address or _free_local_address()
        mp.start_processes(_local_worker, nprocs=num_chips, start_method="spawn",
                           args=(main_func, address, num_chips, host, hosts * num_chips, args))
        return
    if num_processes is not None:
        _init_group(coordinator_address, hosts, host, 0)
    _run(main_func, args)
