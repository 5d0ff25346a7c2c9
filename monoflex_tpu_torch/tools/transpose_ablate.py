"""Ablate the NHWC -> (C, W) relayout that feeds the TPU's v1.5/v3 DCN
layouts, on the card: the counterpart of the JAX package's
``tools/transpose_ablate.py``.

Variants (hot shape (8,96,320,64), R=2 conventions: Cs=64, wp2f=512, P=3):
  xla     F.pad + permute (the plain version, with the row halo)
  dot     F.pad + an einsum with the identity that emits the transposed layout
  pallas  the relayout kernel ``csrc/relayout.cu`` (core rows)
  pallasT the same kernel: both TPU kernels compute this one function

    python -m monoflex_tpu_torch.tools.transpose_ablate [--shape 8,96,320,64] [--iters 20]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.relayout import relayout, relayout_dot, relayout_reference
from . import require_cuda, write_launch_log
from .trace_time import device_time


def xla_variant(x, R=2):
    return relayout_reference(x, R, row_halo=True)


def dot_variant(x, R=2):
    return relayout_dot(x, R)


def pallas_variant(x, R=2):
    """Core rows only (no row halo), as the JAX tool's kernel."""
    return relayout(x, R)


def pallasT_variant(x, R=2):
    return relayout(x, R)


VARIANTS = {"xla": xla_variant, "dot": dot_variant, "pallas": pallas_variant,
            "pallasT": pallasT_variant}


def max_err(name: str, out: torch.Tensor, ref: torch.Tensor, R: int = 2) -> float:
    """The JAX tool's check: xla is the reference, dot is held to all of it,
    the kernels to its core rows."""
    if name == "xla":
        return 0.0
    if name == "dot":
        return (out - ref).abs().max().item()
    P = R + 1
    return (out - ref[:, P:P + out.shape[1]]).abs().max().item()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="8,96,320,64")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", default="xla,dot,pallas,pallasT")
    args = ap.parse_args(argv)
    require_cuda("transpose_ablate")
    B, H, W, C = map(int, args.shape.split(","))
    x = torch.from_numpy(np.random.RandomState(0).randn(B, H, W, C).astype(np.float32)).cuda()

    ref = xla_variant(x)
    for name in args.variants.split(","):
        fn = VARIANTS[name]
        err = max_err(name, fn(x), ref)
        ms, by_op = device_time(lambda: fn(x), iters=args.iters)
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:4]
        print(f"{name:7s} ms/call={ms:7.3f}  maxerr={err:.2e}  top={top}")
    write_launch_log()


if __name__ == "__main__":
    main()
