"""One full training step over n processes at a tiny size (counterpart of
``__graft_entry__.py::dryrun_multichip``)::

    python -m monoflex_tpu_torch.parallel.dryrun [N]          # on N cards
    python -m monoflex_tpu_torch.parallel.dryrun 2 --cpu      # N gloo ranks on the CPU

``runs/monoflex.yaml`` at 64x128, batch n (one image a rank), from
``data/synthetic.py::make_train_batch`` (the port's ``make_dummy_batch``):
the model in DistributedDataParallel, train-mode BN on the global batch's
statistics, the loss over the global batch, one AdamW step.  NCCL on the
cards, gloo on the CPU, over a ``tcp://`` rendezvous on this host; one
process a rank (n = 1 runs in the calling process, still in a group).  Rank
0 prints the JAX line ``dryrun_multichip(n) OK: total_loss=...``.
"""

from __future__ import annotations

import argparse
import os
import socket

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _rank_step(rank: int, n: int, address: str, device_type: str, results) -> None:
    """One rank: its image of the global batch through one train step."""
    from ..config import get_cfg_defaults
    from ..data.synthetic import make_train_batch
    from ..losses.loss_computation import LossComputer
    from ..models.detector import build_model
    from ..train.solver import build_optimizer
    from ..train.train_step import TrainState, make_train_step
    from .mesh import wrap_model

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://{address}", world_size=n, rank=rank)
    try:
        cfg = get_cfg_defaults()
        cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
        model = build_model(cfg, device=device, seed=0)
        optimizer, _, _ = build_optimizer(cfg, model)
        batch = make_train_batch(n, input_height=64, input_width=128, n_valid=2)
        batch = {k: torch.from_numpy(v[rank:rank + 1]).to(device) for k, v in batch.items()}
        step = make_train_step(wrap_model(model, device), LossComputer(cfg), optimizer)
        _, metrics = step(TrainState(), batch)
        total = float(metrics["total_loss"])
        if rank == 0:
            results.put(total)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device: str = "cuda") -> float:
    """One training step over ``n`` ranks on ``device`` ("cuda": one card a
    rank, NCCL; "cpu": gloo); prints the JAX line and returns the global
    total loss."""
    device_type = torch.device(device).type
    if device_type == "cuda" and torch.cuda.device_count() < n:
        raise SystemExit(f"dryrun_multichip({n}): needs {n} CUDA card(s), found "
                         f"{torch.cuda.device_count()}")
    address = _free_address()
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    if n == 1:
        _rank_step(0, 1, address, device_type, results)
    else:
        mp.start_processes(_rank_step, args=(n, address, device_type, results), nprocs=n,
                           start_method="spawn")
    total = results.get()
    if total != total:
        raise AssertionError("training step produced NaN")
    print(f"dryrun_multichip({n}) OK: total_loss={total:.4f}", flush=True)
    return total


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", nargs="?", type=int, default=1, help="ranks (one card each)")
    parser.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
