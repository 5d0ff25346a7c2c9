"""DCN kernel variant sweep on the card with timing taken three ways, the
counterpart of the JAX package's ``tools/kernel_sweep.py``::

    python -m monoflex_tpu_torch.tools.kernel_sweep --variants f32r2,bf16r2,f32r1,bf16r1 \\
        --shapes 0,3,7 --out output/ksweep.jsonl

For each variant (``kernel_bench.VARIANTS``: f32 or bf16 window math, R = 2
or 1) and shape of ``kernel_bench.MODEL_SHAPES`` (``--shapes`` i,j | all;
Co = C, so that a kernel's output can feed its next call), each kernel of
``--what`` is timed:

  fwd   the v1 route, ``dcn_forward`` at ``compute_dtype`` (csrc/dcn_fwd.cu)
  fwd2  the v2 route: the same kernel on the card, as the JAX v2 forward
        computes the same function
  dx    ``dcn_bwd_dx`` (csrc/dcn_bwd_dx.cu)
  dwm   the JAX tool's dmask/dW kernel and
  doff  its doffset kernel: one kernel on the card, ``dcn_bwd_dwmo``
        (csrc/dcn_bwd_dwmo.cu), which gives dmask, dW and doffset together;
        each is timed chained back onto x (x + mean(dmask) for dwm,
        x + mean(doffset) for doff), as the JAX tool chains them

in the JAX tool's three ways: ``ms_loop`` (``--iters`` calls, one
synchronisation at the end), ``ms_device`` (``tools/trace_time.py``: the
device time of the calls' kernels from a torch.profiler trace, the trusted
number) and ``ms_percall`` (a synchronisation after every call, so host
dispatch is included).  A kernel that refuses a shape gives a record
with its error (dcn_bwd_dwmo takes Co <= 256, so dwm and doff at shape 7,
C = Co = 512).  One JSON line per record; with ``--out`` each is
also appended to that file.  ``compile_s`` is the first call's time (the
kernels' build when it is the first call of the process) less one call.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Callable, Tuple

import numpy as np
import torch

from ..ops import dcn_cuda
from . import require_cuda, write_launch_log
from .kernel_bench import MODEL_SHAPES, VARIANTS
from .trace_time import device_time

WHAT = ("fwd", "fwd2", "dx", "dwm", "doff")
# what each record's kernel is on the card
ROUTES = {"fwd": "dcn_fwd", "fwd2": "dcn_fwd", "dx": "dcn_bwd_dx",
          "dwm": "dcn_bwd_dwmo (dmask, dW, doffset in one kernel; chained on dmask)",
          "doff": "dcn_bwd_dwmo (dmask, dW, doffset in one kernel; chained on doffset)"}


def time_three_ways(fn: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
                    iters: int) -> Tuple[float, float, float, float]:
    """(first call, loop, device, per-call) seconds per call of ``fn(x0)``."""
    t0 = time.perf_counter()
    fn(x0)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x0)
    torch.cuda.synchronize()
    t_loop = (time.perf_counter() - t0) / iters

    dev_ms, _ = device_time(lambda: fn(x0), iters=iters)

    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x0)
        torch.cuda.synchronize()
    t_percall = (time.perf_counter() - t0) / iters
    return first, t_loop, dev_ms / 1e3, t_percall


def kernels(dtype: torch.dtype, R: int, off, mask, w, b, g):
    """The function of x that each ``--what`` entry times."""
    def fwd(x):
        return dcn_cuda.dcn_forward(x, off, mask, w, b, max_offset=R, compute_dtype=dtype)

    def dx(x):
        return dcn_cuda.dcn_bwd_dx(x, off, mask, w, g, max_offset=R, compute_dtype=dtype)

    def chained(index):
        def fn(x):
            leaf = dcn_cuda.dcn_bwd_dwmo(x, off, mask, w, g, max_offset=R,
                                         compute_dtype=dtype)[index]
            return x + leaf.mean()
        return fn

    return {"fwd": fwd, "fwd2": fwd, "dx": dx, "dwm": chained(0), "doff": chained(2)}


@torch.no_grad()
def sweep(variants, shapes, what, batch: int, iters: int, device="cuda"):
    """Yield one record per (variant, shape, kernel), inputs drawn in the JAX
    tool's order from one RandomState(0)."""
    rng = np.random.RandomState(0)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    for vname in variants:
        dtype, R = VARIANTS[vname]
        for (H, W, C, _) in shapes:
            # x holds the dtype's values, as the JAX tool makes it in that dtype
            x0 = f32(rng.randn(batch, H, W, C)).to(dtype).float()
            off = f32(rng.randn(batch, H, W, 18) * 1.5)
            mask = f32(rng.rand(batch, H, W, 9))
            w = f32(rng.randn(3, 3, C, C) * 0.05)       # square, for chaining
            b = torch.zeros((C,), device=device)
            g = f32(rng.randn(batch, H, W, C))
            fns = kernels(dtype, R, off, mask, w, b, g)
            for name in what:
                rec = {"variant": vname, "shape": [H, W, C, C], "kernel": name,
                       "route": ROUTES[name], "batch": batch,
                       "device": torch.cuda.get_device_name(x0.device)}
                try:
                    first, tl, tc, tp = time_three_ways(fns[name], x0, iters)
                    rec.update(ms_loop=round(tl * 1e3, 3), ms_device=round(tc * 1e3, 3),
                               ms_percall=round(tp * 1e3, 3),
                               compile_s=round(first - tl, 1))
                except Exception:  # noqa: BLE001 - log and continue the sweep
                    rec["error"] = traceback.format_exc()[-1200:]
                yield rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="f32r2,bf16r2,f32r1,bf16r1")
    ap.add_argument("--shapes", default="0", help="i,j,k or 'all' (kernel_bench.MODEL_SHAPES)")
    ap.add_argument("--what", default="fwd,dx,dwm,doff", help=f"of {','.join(WHAT)}")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="also append each JSON line to this file")
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    what = args.what.split(",")
    bad = [v for v in variants if v not in VARIANTS] + [k for k in what if k not in WHAT]
    if bad:
        ap.error(f"unknown variants or kernels: {bad}")
    shapes = (MODEL_SHAPES if args.shapes == "all"
              else [MODEL_SHAPES[int(i)] for i in args.shapes.split(",")])
    require_cuda("kernel_sweep")
    for rec in sweep(variants, shapes, what, args.batch, args.iters):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    write_launch_log()


if __name__ == "__main__":
    main()
