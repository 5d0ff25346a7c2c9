"""Device times of dcn_fwd's ablations (``ops/dcn_ablate.py``) and of the
calls timed beside them, and dcn_fwd's outputs on seeded inputs, for one
checkout of the port, so that two commits can be compared on one card::

    python monoflex_tpu_torch/tools/ablate_time.py [--root DIR] [--fwd-out PATH]
        [--fwd-against PATH] [--no-times]

``--root`` is the checkout whose ``monoflex_tpu_torch`` is imported (default:
the one holding this file; an older commit unpacked with ``git archive``
builds its own kernels into its own ``_build/``).  For kernel_diag's two
default shapes, batch 8, R = 2, it prints one JSON line of device ms per
call: dcn_fwd (f32 x, no bias), each ablation variant, ``x.clone()`` (dma's
library call) and ``F.conv2d`` with nomap's combined kernel, each timed by
``graph_ms`` over ``rotating`` copies of the inputs.  ``--fwd-out`` saves
dcn_fwd's outputs in five modes (f32 x, f32 x cast to bf16 in the kernel, bf16
x with a bias, the BN+ReLU epilogue, bf16 window math) at four shapes;
``--fwd-against`` compares them bit for bit with an earlier save and exits 1
if any differs.  Run as a file, not with ``-m``: the package it times is
imported from ``--root``.  ``chip_smoke.py`` times its diag phase with this
module's ``graph_ms`` and ``rotating``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

L2_BYTES = 50 * 2 ** 20   # the H100 SXM's L2
BATCH = 8
R = 2
# kernel_diag's default shapes, 0 and 4 of tools/kernel_bench.py::MODEL_SHAPES:
# (H, W, C, Co)
SHAPES = ((96, 320, 64, 64), (24, 80, 256, 128))
# dcn_fwd's bit-equality shapes: the two above and ida_0's widest, at batch
# 2, and one off every tile: (B, H, W, C, Co)
FWD_SHAPES = ((2, 96, 320, 64, 64), (2, 24, 80, 256, 128), (2, 12, 40, 512, 256),
              (2, 13, 37, 72, 40))


def rotating(*tensors: torch.Tensor, min_bytes: int = 2 * L2_BYTES):
    """Sets of copies of ``tensors``, as many as take ``min_bytes`` together
    (at least two), so that calls that cycle through them read their inputs
    from device memory, not from the L2 the previous call left them in."""
    per_set = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, -(-min_bytes // per_set))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def graph_ms(fn, sets, iters: int) -> float:
    """Device ms per call of ``fn(*sets[i % len(sets)])``: ``iters`` calls
    captured in one CUDA graph, each keeping its output (a buffer of its own,
    so no write lands on lines an earlier call left in L2), and replayed
    between CUDA events, so the host's cost of a launch is not in the time."""
    fn(*sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*sets[i % len(sets)]) for i in range(iters)]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph, outs
    return start.elapsed_time(end) / iters


def nomap_conv_weight(w: torch.Tensor, max_offset: int) -> torch.Tensor:
    """nomap as one convolution: the (2R+3) x (2R+3) kernel 1/4 (box_{2R+1}
    * W_k) summed over the taps, (Co, C, 2R+3, 2R+3), channels-last."""
    C, Co = w.shape[2:]
    n = 2 * max_offset + 1
    K = torch.zeros(Co, C, n + 2, n + 2, device=w.device)
    for k in range(9):
        ky, kx = k // 3, k % 3
        K[:, :, ky:ky + n, kx:kx + n] += 0.25 * w[ky, kx].T[..., None, None]
    return K.contiguous(memory_format=torch.channels_last)


def diag_inputs(seed: int, H: int, W: int, C: int, Co: int, batch: int = BATCH):
    """x, offset (1.5 sigma), mask and W on the card from ``seed``, as
    chip_smoke.py's diag phase makes them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(batch, H, W, C, device="cuda", generator=g),
            torch.randn(batch, H, W, 18, device="cuda", generator=g) * 1.5,
            torch.rand(batch, H, W, 9, device="cuda", generator=g),
            torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5)


def ablation_times(dcn_cuda, dcn_ablate, variants, iters: int):
    """One record per shape: device ms of each call (module docstring)."""
    records = []
    for i, (H, W, C, Co) in enumerate(SHAPES):
        x, off, mask, w = diag_inputs(300 + i, H, W, C, Co)
        sets = rotating(x, off, mask, w)
        K = nomap_conv_weight(w, R)
        calls = {"dcn_fwd": lambda *a: dcn_cuda.dcn_forward(*a, None, max_offset=R)}
        for v in variants:
            calls[v] = lambda *a, v=v: dcn_ablate(*a, variant=v, max_offset=R)
        calls["x.clone"] = lambda x, *_: x.clone()
        calls["F.conv2d(nomap)"] = lambda x, *_: F.conv2d(x.permute(0, 3, 1, 2), K,
                                                         padding=R + 1)
        with torch.no_grad():
            ms = {name: graph_ms(fn, sets, iters) for name, fn in calls.items()}
        records.append({"shape": [BATCH, H, W, C, Co], "R": R, "sets": len(sets), "ms": ms})
        del x, off, mask, w, sets
        torch.cuda.empty_cache()
    return records


def fwd_outputs(dcn_cuda) -> dict:
    """dcn_fwd's outputs at FWD_SHAPES in five modes (module docstring)."""
    bf16 = torch.bfloat16
    out = {}
    for i, (B, H, W, C, Co) in enumerate(FWD_SHAPES):
        x, off, mask, w = diag_inputs(500 + i, H, W, C, Co, batch=B)
        g = torch.Generator(device="cuda").manual_seed(600 + i)
        bias, scale, shift = (torch.randn(Co, device="cuda", generator=g) for _ in range(3))
        key = "x".join(map(str, (B, H, W, C, Co)))
        with torch.no_grad():
            out[f"f32x/{key}"] = dcn_cuda.dcn_forward(x, off, mask, w, None, max_offset=R)
            out[f"folded/{key}"] = dcn_cuda.dcn_forward(x, off, mask, w, None, max_offset=R,
                                                        transfer_dtype=bf16)
            out[f"bn_relu/{key}"] = dcn_cuda.dcn_forward_bn_relu(
                x, off, mask, w, scale, shift, max_offset=R, transfer_dtype=bf16)
            out[f"bf16_math/{key}"] = dcn_cuda.dcn_forward(
                x, off, mask, w, None, max_offset=R, transfer_dtype=bf16, compute_dtype=bf16)
        # with a gradient to keep, x goes to the kernel in bf16
        xg = x.clone().requires_grad_(True)
        out[f"bf16x_bias/{key}"] = dcn_cuda.dcn_forward(xg, off, mask, w, bias, max_offset=R,
                                                        transfer_dtype=bf16).detach()
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--fwd-out", type=Path)
    parser.add_argument("--fwd-against", type=Path)
    parser.add_argument("--no-times", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    from monoflex_tpu_torch.ops import dcn_cuda
    from monoflex_tpu_torch.ops.dcn_ablate import VARIANTS, dcn_ablate
    from monoflex_tpu_torch.tools import require_cuda

    # exits without a card; the default config's precision (TF32 off, cuDNN
    # autotune), as chip_smoke.py's
    require_cuda("ablate_time")
    root = str(args.root)
    if not args.no_times:
        for rec in ablation_times(dcn_cuda, dcn_ablate, VARIANTS, args.iters):
            print(json.dumps({"root": root, **rec}), flush=True)
    if args.fwd_out or args.fwd_against:
        outs = fwd_outputs(dcn_cuda)
        if args.fwd_out:
            torch.save(outs, args.fwd_out)
        if args.fwd_against:
            ref = torch.load(args.fwd_against)
            differ = sorted(k for k in ref if k not in outs or not torch.equal(outs[k], ref[k]))
            print(json.dumps({"root": root, "fwd_outputs": len(ref),
                              "bit_equal": len(ref) - len(differ), "differ": differ}), flush=True)
            if differ or set(outs) != set(ref):
                raise SystemExit(1)


if __name__ == "__main__":
    main()
