"""Decompose the DCN forward kernel's cost into parts on the card, the
counterpart of the JAX package's ``tools/kernel_diag.py``.

Times variants that strip ``csrc/dcn_fwd.cu`` to one part each
(``ops/dcn_ablate.py``, kernel ``csrc/dcn_ablate.cu``):

  full     the forward itself: ``dcn_fwd``, f32 x, no bias
  dma      the halo staging only: x copied through a staged tile
  window   the 4-corner gather only (no mask, no matmul; out = sum of taps)
  aligned  the window with the column shifts dropped
  matmul   the per-tap im2col product only (one aligned term per tap)
  rowdot   as full (the JAX kernel falls through to its full body)

Usage:
    python -m monoflex_tpu_torch.tools.kernel_diag --shapes 0,4 \\
        --variants full,dma,window,aligned,matmul --out kdiag.jsonl
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops import dcn_cuda
from ..ops.dcn_ablate import dcn_ablate
from . import require_cuda, write_launch_log
from .kernel_bench import MODEL_SHAPES

FULL = ("full", "rowdot")
ABLATIONS = ("dma", "window", "aligned", "matmul")


@torch.no_grad()
def run_variant(x, offset, mask, weight, R: int, variant: str) -> torch.Tensor:
    """(B,H,W,C) for dma/window/aligned, (B,H,W,Co) for the others."""
    if variant in FULL:
        return dcn_cuda.dcn_forward(x, offset, mask, weight, None, max_offset=R)
    if variant in ABLATIONS:
        return dcn_ablate(x, offset, mask, weight, variant=variant, max_offset=R)
    raise ValueError(f"variant must be one of {FULL + ABLATIONS}, got {variant!r}")


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize()


def measure(x, off, mask, w, R: int, variant: str, iters: int) -> dict:
    """compile_s (the first call, with one link of the chain) and ms per
    call over a serial chain of ``iters`` calls, each fed through a data
    dependency on the last.  The warm-up link loads the chain's own
    elementwise kernels, which would otherwise land in the first timed
    variant's ms."""
    rec = {}
    t0 = time.perf_counter()
    acc = x + 0.0 * run_variant(x, off, mask, w, R, variant)[..., :1]
    _sync(acc)
    rec["compile_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    for _ in range(iters):
        o = run_variant(acc, off, mask, w, R, variant)
        acc = acc + 0.0 * o[..., :1]  # depend on o, keep shape
    _sync(acc)
    rec["ms"] = round((time.perf_counter() - t0) / iters * 1e3, 3)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="0,4")
    ap.add_argument("--variants", default="full,dma,window,aligned,matmul")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--R", type=int, default=2)
    ap.add_argument("--out", default=None, help="also append each JSON line to this file")
    args = ap.parse_args(argv)
    require_cuda("kernel_diag")

    rng = np.random.RandomState(0)
    B = args.batch
    for si in args.shapes.split(","):
        H, W, C, Co = MODEL_SHAPES[int(si)]

        def cuda(a):
            return torch.from_numpy(np.asarray(a, np.float32)).cuda()

        x = cuda(rng.randn(B, H, W, C))
        off = cuda(rng.randn(B, H, W, 18) * 1.5)
        mask = cuda(rng.rand(B, H, W, 9))
        w = cuda(rng.randn(3, 3, C, Co) * 0.05)
        for variant in args.variants.split(","):
            rec = {"variant": variant, "shape": [H, W, C, Co], "batch": B,
                   "device": torch.cuda.get_device_name(0)}
            try:
                rec.update(measure(x, off, mask, w, args.R, variant, args.iters))
            except Exception as e:  # noqa: BLE001
                rec["error"] = repr(e)[:400]
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    write_launch_log()


if __name__ == "__main__":
    main()
