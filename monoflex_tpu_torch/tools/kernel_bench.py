"""DCN kernel micro-benchmark on the card, the counterpart of the JAX
package's ``tools/kernel_bench.py``.

Times the v1 route (``dcn_pallas`` at ``max_offset=R`` and its
``compute_dtype``: the port's ``dcn_forward`` on ``csrc/dcn_fwd.cu``) and,
with ``--bwd``, the v1 backward (``dcn_pallas_bwd``: ``dcn_backward``, i.e.
``dcn_bwd_dx`` + ``dcn_bwd_dwmo`` + the sum of g) for every DCN shape the
model instantiates at 384x1280, across the dtype/R variants: f32 math, or
the bf16 window math.  Prints one JSON line per measurement and, with
--out, appends it to that file.  ``fwd_compile_s`` is the first call's
time less one timed call: the kernels' build when it is the first call of
the process.

    python -m monoflex_tpu_torch.tools.kernel_bench --variants f32r2,bf16r1 --bwd
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops import dcn_cuda
from . import require_cuda, write_launch_log

# (H, W, C, Co) of every DCN call in the neck at 384x1280 (the JAX tool's
# list, in its order; its rows 1 and 6, (48,160,64,64) and (24,80,64,64), are
# shapes the model never calls and are corrected here: ROADMAP C7)
MODEL_SHAPES = [
    (96, 320, 64, 64),    # ida_2 node_1..3, ida_up node_1..2 (5 calls)
    (48, 160, 128, 64),   # ida_up proj_1
    (48, 160, 128, 128),  # ida_1 node_1..2
    (48, 160, 128, 64),   # ida_2 proj_1..3
    (24, 80, 256, 128),   # ida_1 proj_1..2
    (24, 80, 256, 256),   # ida_0 node_1
    (24, 80, 256, 64),    # ida_up proj_2
    (12, 40, 512, 256),   # ida_0 proj_1
]

VARIANTS = {
    "f32r2": (torch.float32, 2),
    "f32r1": (torch.float32, 1),
    "bf16r2": (torch.bfloat16, 2),
    "bf16r1": (torch.bfloat16, 1),
}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def bench_one(fn, args, iters: int = 20, device="cuda") -> float:
    """Seconds per call: one call, then ``iters`` timed calls, synchronised."""
    fn(*args)
    _sync(device)
    start = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - start) / iters


def pick_shapes(spec: str):
    if spec == "all":
        return MODEL_SHAPES
    if spec == "first":
        return MODEL_SHAPES[:1]
    return [MODEL_SHAPES[int(i)] for i in spec.split(",")]


@torch.no_grad()
def measure(vname: str, shape, batch: int, iters: int, bwd: bool, rng: np.random.RandomState,
            device="cuda") -> dict:
    """One record: the forward (and with ``bwd`` the backward) of variant
    ``vname`` at (H, W, C, Co) = shape, inputs drawn from ``rng`` in the JAX
    tool's order."""
    dtype, R = VARIANTS[vname]
    H, W, C, Co = shape
    B = batch

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    # x holds the dtype's values, as the JAX tool makes it in that dtype
    x = f32(rng.randn(B, H, W, C)).to(dtype).float()
    off = f32(rng.randn(B, H, W, 18) * 1.5)
    mask = f32(rng.rand(B, H, W, 9))
    w = f32(rng.randn(3, 3, C, Co) * 0.05)
    b = torch.zeros((Co,), device=device)
    rec = {"variant": vname, "shape": [H, W, C, Co], "batch": B,
           "device": torch.cuda.get_device_name(device) if x.is_cuda else "cpu"}
    try:
        t0 = time.perf_counter()
        dt = bench_one(lambda *a: dcn_cuda.dcn_forward(*a, max_offset=R, compute_dtype=dtype),
                       (x, off, mask, w, b), iters, device)
        rec["fwd_ms"] = round(dt * 1e3, 3)
        rec["fwd_compile_s"] = round(time.perf_counter() - t0 - dt * iters, 1)
    except Exception as e:  # noqa: BLE001 - log and continue the sweep
        rec["fwd_error"] = repr(e)[:500]
    if bwd and "fwd_error" not in rec:
        g = f32(rng.randn(B, H, W, Co))
        try:
            t0 = time.perf_counter()
            dt = bench_one(lambda *a: dcn_cuda.dcn_backward(*a, max_offset=R, compute_dtype=dtype),
                           (x, off, mask, w, g), iters, device)
            rec["bwd_ms"] = round(dt * 1e3, 3)
            rec["bwd_compile_s"] = round(time.perf_counter() - t0 - dt * iters, 1)
        except Exception as e:  # noqa: BLE001
            rec["bwd_error"] = repr(e)[:500]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="f32r2,bf16r1")
    ap.add_argument("--shapes", default="all", help="'all', 'first' or i,j,k")
    ap.add_argument("--bwd", action="store_true", help="also time backward kernels")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None, help="also append each JSON line to this file")
    args = ap.parse_args(argv)
    require_cuda("kernel_bench")

    rng = np.random.RandomState(0)
    for vname in args.variants.split(","):
        for shape in pick_shapes(args.shapes):
            line = json.dumps(measure(vname, shape, args.batch, args.iters, args.bwd, rng))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    write_launch_log()


if __name__ == "__main__":
    main()
