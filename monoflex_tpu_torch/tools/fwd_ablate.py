"""Ablate the DCN forward on the card, the counterpart of the JAX package's
``tools/fwd_ablate.py``.

The JAX tool times TPU stagings of the v2 forward (hoisted hat maps, 2-pixel
lane packing, C on sublanes, taps under fori) and two math ablations.  Each
staging computes the DCN forward without bias, in f32 or with the bf16
window math; on Hopper it is a route onto ``csrc/dcn_fwd.cu`` in that mode:

  full, hoistwx, fori, hoist3d, packed, v15, packedh3       dcn_fwd, f32
  foribf16, hoist3dbf16, packedbf16, v15bf16, packedh3bf16  dcn_fwd, bf16 math
  nomap    weight maps replaced by a constant (``csrc/dcn_ablate.cu``)
  nobcast  each weight map replaced by its maximum over the row tile
           (``csrc/dcn_ablate.cu``)

packed, packedh3 and their bf16 forms keep the TPU builders' precondition,
C = Co = 64 and W even.  ``--parity`` diffs each variant against the v2
route (``dcn_forward`` at R = 2, f32); nomap and nobcast are math
ablations and differ.

    python -m monoflex_tpu_torch.tools.fwd_ablate [--shape 96,320,64,64] [--iters 20] [--parity]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops import dcn_cuda
from ..ops.dcn_ablate import dcn_ablate
from . import require_cuda, write_launch_log
from .trace_time import device_time

ABLATIONS = ("nomap", "nobcast")
F32_ROUTES = ("full", "hoistwx", "fori")


def _route(max_offset: int, compute_dtype: torch.dtype):
    @torch.no_grad()
    def fn(x, offset, mask, weight):
        return dcn_cuda.dcn_forward(x, offset, mask, weight, None, max_offset=max_offset,
                                    compute_dtype=compute_dtype)
    return fn


def _check_packed(shapes) -> None:
    _, _, W, C, Co = shapes
    if not (C == 64 and Co == 64 and W % 2 == 0):
        raise ValueError(f"the packed layout needs C = Co = 64 and W even, got C={C} Co={Co} W={W}")


def build_hoist3d(shapes, max_offset=2, compute_dtype=torch.float32):
    """``tools/fwd_ablate.py::build_hoist3d`` (staged hat maps): the DCN."""
    return _route(max_offset, compute_dtype)


def build_packed(shapes, max_offset=2, compute_dtype=torch.float32):
    """``build_packed`` (two pixels per 128-lane tile): the DCN, C = Co = 64."""
    _check_packed(shapes)
    return _route(max_offset, compute_dtype)


def build_v15(shapes, max_offset=2, compute_dtype=torch.float32):
    """``build_v15`` (C on sublanes, W on lanes): the DCN."""
    return _route(max_offset, compute_dtype)


def build_packed_h3(shapes, max_offset=2, compute_dtype=torch.float32):
    """``build_packed_h3`` (packed, staged hat maps): the DCN, C = Co = 64."""
    _check_packed(shapes)
    return _route(max_offset, compute_dtype)


def build_variant(variant, shapes, max_offset=2):
    """``build_variant``: full/hoistwx/fori (f32) and foribf16 (bf16 math)
    are the DCN; nomap and nobcast are the ablations."""
    if variant in ABLATIONS:
        @torch.no_grad()
        def fn(x, offset, mask, weight):
            return dcn_ablate(x, offset, mask, weight, variant=variant, max_offset=max_offset)
        return fn
    if variant in F32_ROUTES:
        return _route(max_offset, torch.float32)
    if variant == "foribf16":
        return _route(max_offset, torch.bfloat16)
    raise ValueError(f"unknown variant {variant!r}")


BUILDERS = {"packed": build_packed, "packedh3": build_packed_h3, "v15": build_v15,
            "hoist3d": build_hoist3d}


def build(variant, shapes):
    """The function the JAX tool's main builds for ``variant``."""
    base = variant[:-4] if variant.endswith("bf16") else variant
    if base in BUILDERS:
        dtype = torch.bfloat16 if variant.endswith("bf16") else torch.float32
        return BUILDERS[base](shapes, compute_dtype=dtype)
    return build_variant(variant, shapes)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="96,320,64,64")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", default="full,nomap,nobcast,hoistwx")
    ap.add_argument("--parity", action="store_true",
                    help="also diff each variant against the production "
                         "kernel on device (nomap/nobcast are math ablations "
                         "and expected to differ)")
    args = ap.parse_args(argv)
    require_cuda("fwd_ablate")
    H, W, C, Co = (int(v) for v in args.shape.split(","))
    rng = np.random.RandomState(0)

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    x = cuda(rng.randn(args.batch, H, W, C))
    off = cuda(rng.randn(args.batch, H, W, 18) * 1.5)
    mask = cuda(rng.rand(args.batch, H, W, 9))
    w = cuda(rng.randn(3, 3, C, Co) * 0.05)

    for v in args.variants.split(","):
        fn = build(v, (args.batch, H, W, C, Co))
        try:
            t0 = time.perf_counter()
            out = fn(x, off, mask, w)
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 — keep measuring the rest
            print(f"{v:12s} FAILED: {str(exc)[:300]}", flush=True)
            continue
        compile_s = time.perf_counter() - t0
        ms, _ = device_time(lambda: fn(x, off, mask, w), iters=args.iters)
        rel = ""
        if args.parity:
            ref = _route(2, torch.float32)(x, off, mask, w)
            denom = ref.abs().max().item() or 1.0
            rel = f"  relerr {(ref - out).abs().max().item() / denom:.2e}"
        print(f"{v:12s} compile {compile_s:6.1f}s  device {ms:8.3f} ms/call"
              f"{rel}", flush=True)
    write_launch_log()


if __name__ == "__main__":
    main()
