"""FLOPs per image and model-FLOPs utilisation of the flagship model
(counterpart of the JAX package's ``tools/flops.py``, with its flags and its
JSON keys).

``torch.utils.flop_counter`` counts the convolutions and matrix products of
one forward (batch ``--batch`` at 384x1280, ``runs/monoflex.yaml``, seeded
weights) and of one full training step, with the DCN layers on the plain op
("gather": its contraction is a matrix product the counter sees; the
kernels are opaque to it, and their arithmetic is the same).  XLA's cost
model, which the JAX tool reads, also counts elementwise operations, so
this count lies a little below it (``tests/test_torch_flops.py``); the
counter does not count bytes, so ``bytes_accessed_fwd_gb_per_img`` is null.
The utilisation divides the FLOPs at the given throughputs by the H100 SXM
data sheet's dense peaks, as ``PERF.md`` §6's bounds do: 67 TFLOP/s f32
(CUDA cores) and 989 TFLOP/s bf16 (tensor cores).  The default throughputs
are the port's own f32 readings on one H100 (``PERF.md`` §5: forward+decode
123.55 img/s, the training step 30.03 img/s, batch 8)::

    python -m monoflex_tpu_torch.tools.flops [--img_s 123.55] [--train_img_s 30.03]

It runs on the card and exits non-zero without one; ``MONOFLEX_PLATFORM=cpu``
runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
H100_PEAK_F32_TFLOPS = 67.0
H100_PEAK_BF16_TFLOPS = 989.0


def count_flops(batch_size: int = 1, height: int = 384, width: int = 1280, device="cuda"):
    """(forward FLOPs, training-step FLOPs) per image of runs/monoflex.yaml
    with the DCNs on the plain op."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..config import get_cfg_defaults
    from ..data.synthetic import make_train_batch
    from ..losses.loss_computation import LossComputer
    from ..models.detector import build_model
    from ..train.solver import build_optimizer
    from ..train.train_step import TrainState, make_train_step

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
    cfg.TPU.DCN_FORCE_IMPL = "gather"   # the plain op: its product is visible to the counter
    model = build_model(cfg, device=device, seed=0)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in make_train_batch(batch_size, height, width).items()}
    model.eval()
    with torch.no_grad(), FlopCounterMode(display=False) as fwd:
        model(batch["image"], batch["edge_indices"], batch["edge_len"])
    optimizer, _, _ = build_optimizer(cfg, model)
    step = make_train_step(model, LossComputer(cfg), optimizer)
    with FlopCounterMode(display=False) as train:
        step(TrainState(), batch)
    return fwd.get_total_flops() / batch_size, train.get_total_flops() / batch_size


def report(fwd_flops: float, train_flops: float, img_s: float, train_img_s: float) -> dict:
    def mfu(flops, rate):
        tflops = flops * rate / 1e12
        return {"img_s": rate, "achieved_tflops": round(tflops, 3),
                "mfu_vs_f32_peak_pct": round(100 * tflops / H100_PEAK_F32_TFLOPS, 2),
                "mfu_vs_bf16_peak_pct": round(100 * tflops / H100_PEAK_BF16_TFLOPS, 2)}

    return {"fwd_gflops_per_img": round(fwd_flops / 1e9, 2),
            "train_gflops_per_img": round(train_flops / 1e9, 2),
            "bytes_accessed_fwd_gb_per_img": None,
            "inference": mfu(fwd_flops, img_s), "train": mfu(train_flops, train_img_s)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--img_s", type=float, default=123.55,
                    help="measured inference img/s to convert to MFU")
    ap.add_argument("--train_img_s", type=float, default=30.03,
                    help="measured train img/s to convert to MFU")
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args(argv)

    from ..cli import require_device, run_device

    require_device()
    fwd, train = count_flops(args.batch, device=run_device())
    print(json.dumps(report(fwd, train, args.img_s, args.train_img_s), indent=1))
    from . import write_launch_log

    write_launch_log()


if __name__ == "__main__":
    main()
