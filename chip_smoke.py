#!/usr/bin/env python3
"""Drive the PyTorch port's inference path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:
  1. device  CUDA is required (there is no CPU path); the card's name and
             power limit as nvidia-smi reports them.
  2. build   compile monoflex_tpu_torch/csrc/dcn_fwd.cu for sm_90a.
  3. kernel  the DCNv2 kernel against the plain PyTorch op at the neck's DCN
             shapes, batch 8, R=2, x in bf16: max abs error against the
             tolerance, ms per call of each.
  4. slice   runs/monoflex.yaml at 384x1280, batch 8, seeded weights with the
             offset/mask convs perturbed off zero: one warm-up, then 3
             forward+decode passes that must launch the kernel 16 times each
             and give finite (8, 50, 14) rows; the head maps against the same
             model on the plain op (bf16 x as served, and f32 x).
  5. report  the kernels' JSON line, the card line, and last the result line
             {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.synthetic import make_inference_batch
from monoflex_tpu_torch.decode.postprocessor import PostProcessor
from monoflex_tpu_torch.models.backbone.dla import DCN
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import modulated_deform_conv

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8
R = 2
# (H, W, C, Co) of the neck's DCNs at 384x1280 and how many of the 16 layers
# run at each.  The two with 0 layers are listed by the JAX package's kernel
# tool (tools/compile_v2_kernels.py) but the model never calls them.
DCN_SHAPES = [
    ((96, 320, 64, 64), 5),
    ((48, 160, 128, 64), 4),
    ((48, 160, 128, 128), 2),
    ((24, 80, 256, 128), 2),
    ((24, 80, 256, 256), 1),
    ((24, 80, 256, 64), 1),
    ((12, 40, 512, 256), 1),
    ((48, 160, 64, 64), 0),
    ((24, 80, 64, 64), 0),
]
# kernel vs plain op on the same bf16-rounded x: both accumulate in f32 and
# differ only in summation order over 9*C <= 4608 terms of an O(1) output
KERNEL_TOL = 1e-3
# head maps (sigmoid heatmap and O(1) regression maps), kernel model vs
# plain-op model: summation order again, carried through the 16 DCN layers
# and the heads; with bf16 x a last-bit difference upstream can also round an
# element of the next layer's x to the neighbouring bf16 value
HEADS_TOL = 1e-3


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def time_ms(fn, iters: int) -> float:
    """Device ms per call, CUDA events around ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel() -> dict:
    worst = 0.0
    ms_fwd = plain_fwd = 0.0
    for i, ((H, W, C, Co), layers) in enumerate(DCN_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(i)
        x = torch.randn(BATCH, H, W, C, device="cuda", generator=g)
        # fractional, and beyond +-R often enough to exercise the clamp
        off = torch.randn(BATCH, H, W, 18, device="cuda", generator=g) * 1.5
        mask = torch.rand(BATCH, H, W, 9, device="cuda", generator=g)
        w = torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5
        b = torch.randn(Co, device="cuda", generator=g) * 0.1
        args = (x, off, mask, w, b)
        kw = dict(max_offset=R, transfer_dtype=torch.bfloat16)

        def kernel():
            return dcn_cuda.dcn_forward(*args, **kw)

        def plain():
            return modulated_deform_conv(*args, **kw)

        y = kernel()
        err = (y - plain()).abs().max().item()
        if not (err <= KERNEL_TOL and torch.isfinite(y).all()):
            raise AssertionError(f"dcn_fwd {(BATCH, H, W, C, Co)}: max abs err {err} > {KERNEL_TOL}")
        # plain, kernel, kernel, plain: drift in clocks hits both sides alike
        p1, k1, k2, p2 = (time_ms(plain, 5), time_ms(kernel, 20),
                          time_ms(kernel, 20), time_ms(plain, 5))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        worst = max(worst, err)
        ms_fwd += layers * k_ms
        plain_fwd += layers * p_ms
        phase("kernel", f"dcn_fwd B,H,W,C,Co={(BATCH, H, W, C, Co)} layers={layers} "
                        f"max_abs_err={err:.3e} (tol {KERNEL_TOL}) kernel_ms={k_ms:.4f} "
                        f"plain_ms={p_ms:.4f}")
        del x, off, mask, w, b, args, y
    torch.cuda.empty_cache()
    phase("kernel", f"per forward (16 layers): kernel_ms={ms_fwd:.4f} plain_ms={plain_fwd:.4f}")
    return {"max_abs_err": worst, "ms": ms_fwd, "plain_ms": plain_fwd}


@torch.no_grad()
def perturb_offset_convs(model: torch.nn.Module, seed: int) -> None:
    """The offset/mask convs start at zero (no deformation).  Give them
    seeded weights so offsets are fractional and some pass +-R."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, DCN):
            conv = m.conv_offset_mask
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 2 / fan_in ** 0.5)
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=g))


def offset_stats(model: torch.nn.Module):
    """Forward hooks that collect |offset| over every DCN of one forward."""
    seen = []

    def hook(_module, _inputs, out):
        o = out[:, :18].abs()
        seen.append(((o > R).float().mean().item(), (o.frac() != 0).float().mean().item()))

    handles = [m.conv_offset_mask.register_forward_hook(hook)
               for m in model.modules() if isinstance(m, DCN)]
    return seen, handles


def max_head_err(a: dict, b: dict) -> float:
    maps = [(a["cls"], b["cls"])] + list(zip(a["reg"], b["reg"]))
    return max((x - y).abs().max().item() for x, y in maps)


def run_slice() -> dict:
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
    model = build_model(cfg, device="cuda", seed=0)
    perturb_offset_convs(model, seed=1)
    post = PostProcessor(cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_inference_batch(BATCH).items()}

    def infer(m):
        out = m(batch["image"], batch["edge_indices"], batch["edge_len"])
        rows, valid, _ = post(out, batch)
        return out, rows, valid

    with torch.inference_mode():
        infer(model)
        torch.cuda.synchronize()
        dcn_cuda.dcn_forward.launches = 0
        passes = 3
        t0 = time.perf_counter()
        for _ in range(passes):
            out, rows, valid = infer(model)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dcn_cuda.dcn_forward.launches

        if launches != 16 * passes:
            raise AssertionError(f"{launches} dcn_fwd launches in {passes} forwards, want {16 * passes}")
        if tuple(rows.shape) != (BATCH, 50, 14) or not torch.isfinite(rows).all():
            raise AssertionError(f"rows {tuple(rows.shape)} finite={bool(torch.isfinite(rows).all())}")
        for key, t in [("cls", out["cls"])] + [(f"reg{i}", r) for i, r in enumerate(out["reg"])]:
            if not torch.isfinite(t).all():
                raise AssertionError(f"head map {key} is not finite")
        phase("slice", f"{passes} forward+decode passes at batch {BATCH}, 384x1280: "
                       f"{BATCH * passes / elapsed:.2f} img/s on {torch.cuda.get_device_name(0)}; "
                       f"dcn_fwd launches={launches}; rows {tuple(rows.shape)} finite, "
                       f"{int(valid.sum())} above threshold")

        stats, handles = offset_stats(model)
        infer(model)
        for h in handles:
            h.remove()
        clamped = sum(s[0] for s in stats) / len(stats)
        fractional = sum(s[1] for s in stats) / len(stats)

        errs = {}
        for label, impl in (("bf16", "pallas3b"), ("f32", "pallas3")):
            cfg.TPU.DCN_FORCE_IMPL = impl
            kern = build_model(cfg, device="cuda", use_dcn_kernel=True)
            plain = build_model(cfg, device="cuda", use_dcn_kernel=False)
            kern.load_state_dict(model.state_dict())
            plain.load_state_dict(model.state_dict())
            errs[label] = max_head_err(infer(kern)[0], infer(plain)[0])
            del kern, plain
        phase("slice", f"offsets: {clamped:.3f} of |o| > R, {fractional:.3f} fractional; "
                       f"head maps kernel vs plain op: max abs err bf16 x {errs['bf16']:.3e}, "
                       f"f32 x {errs['f32']:.3e} (tol {HEADS_TOL})")
        for label, err in errs.items():
            if not err <= HEADS_TOL:
                raise AssertionError(f"head maps ({label} x) differ by {err} > {HEADS_TOL}")
    return {"launches": launches}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on the GPU")
    # full-f32 matmuls and convolutions on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    phase("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
                    f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    dcn_cuda.build()
    phase("build", f"dcn_fwd.cu -> sm_90a in {time.perf_counter() - t0:.2f} s")

    measured = check_kernel()
    measured.update(run_slice())

    print(json.dumps({"kernels": [{
        "name": "dcn_fwd", "route": "cuda",
        "source": "monoflex_tpu_torch/csrc/dcn_fwd.cu",
        "replaces": "monoflex_tpu/ops/dcn_pallas_v3.py:155",
        "launches": measured["launches"], "max_abs_err": measured["max_abs_err"],
        "ms": measured["ms"], "plain_ms": measured["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
