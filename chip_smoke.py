#!/usr/bin/env python3
"""Drive the PyTorch port's inference, training and evaluation paths once on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:
  1. device  CUDA is required (there is no CPU path); the card's name and
             power limit as nvidia-smi reports them.
  2. build   compile every monoflex_tpu_torch/csrc/*.cu for sm_90a, one nvcc
             each, all started together.
  3. kernel  the DCNv2 forward kernel against the plain PyTorch op at the
             neck's DCN shapes, batch 8, R=2, x in bf16: max abs error
             against the tolerance, ms per call of each.
  4. slice   runs/monoflex.yaml at 384x1280, batch 8, seeded weights with the
             offset/mask convs perturbed off zero: one warm-up, then 3
             forward+decode passes that must launch the kernel 16 times each
             and give finite (8, 50, 14) rows; the head maps against the same
             model on the plain op (bf16 x as served, and f32 x).
  5. bwd     the two backward kernels (dx; dmask, dW and doffset) against
             the plain backward at the neck's shapes, batch 8, R=2, x in
             bf16: max errors against the tolerances, ms per call of each.
  6. train   the training step on the same model and batch size: one
             warm-up step, then 3 steps that must launch each of the three
             kernels 16 times per step, give 11 finite loss terms and no
             skipped step, and move the trunk's first conv, a DCN weight and
             an offset/mask conv; then, from one saved state, the loss and
             every gradient of a kernel step against a plain-op step.
  7. eval    the fused BN+ReLU epilogue kernel against its plain version at
             the neck's shapes (and the unfused kernel + BN + ReLU, timed);
             then the evaluation path on a seeded 16-frame KITTI-format tree
             (1242x375, split trainval) at 384x1280, batch 8, seeded weights
             with the offset/mask convs, BNs and DCN biases perturbed: inference()
             under pallas3b, pallas3b with TPU.DCN_FUSE_BN_RELU, pallas2p and
             pallas (v1), each launching its kernel 16 times per forward and
             writing 16 txts with finite R40 AP tables; head maps against the
             plain-op model, fused against unfused; AP against the plain-op
             run; the 8-mode depth sweep, one run_test() and the
             diagnostics (depth errors, disentangled 3D IoU).
  8. report  the kernels' JSON line (with each kernel's bound on the card),
             the card line, and last the result line
             {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import tempfile
import time

import torch
import torch.nn.functional as F

from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.dataset import KITTIDataset
from monoflex_tpu_torch.data.loader import make_test_loader
from monoflex_tpu_torch.data.synthetic import (make_inference_batch, make_synthetic_kitti,
                                               make_train_batch)
from monoflex_tpu_torch.decode.postprocessor import PostProcessor
from monoflex_tpu_torch.engine.inference import (inference, inference_all_depths, run_diagnostics,
                                                 to_device)
from monoflex_tpu_torch.engine.test_net import run_test
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.models.backbone.dla import BN_EPS, DCN
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import (modulated_deform_conv, modulated_deform_conv_backward,
                                        modulated_deform_conv_bn_relu)
from monoflex_tpu_torch.train.solver import build_optimizer
from monoflex_tpu_torch.train.train_step import (TrainState, forward_backward, make_eval_step,
                                                 make_train_step)

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
# backward kernels vs the plain backward on the same bf16-rounded x, f32
# accumulation in another order: dx, dmask and doffset are sums of at most
# 9*C*Co products per element, held to 1e-4 of the largest element; dW sums
# over every pixel of the batch (245,760 at the hot shape), 1e-4 of its
# largest element too
BWD_RTOL = 1e-4
# kernel step vs plain-op step from one saved state, train-mode BN, x in f32
# (pallas3): the total loss to 1e-5 relative; each gradient to 1e-2 relative
# L2 error, since summation-order differences travel through 16 DCN layers
# and the batch statistics of every BN forward and back (the plain step
# against itself with its DCN outputs scaled by 1 + 1e-7 noise moves a
# gradient by up to 5e-4).  With bf16 x the step is not comparable this way:
# a 1e-7 relative nudge of the DCN outputs flips the bf16 rounding of some
# next-layer inputs, and the plain step's own gradients then move by 28%
# (median over parameters), so bf16 is held at the kernel level (phase bwd).
# A bias that feeds a train-mode BN has gradient 0 in exact arithmetic, so
# it is held to 1e-4 of the largest gradient element in the model instead.
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_REL_L2 = 1e-2
ZERO_GRAD_RTOL = 1e-4
# head maps of the fused-epilogue model vs the unfused model, both on the
# kernels, bf16 x: the epilogue applies the BN to the f32 accumulator where
# the unfused model applies it to the stored output (about 1e-6 relative
# apart), and a last-bit difference can round an element of the next layer's
# bf16 x the other way, as for HEADS_TOL
FUSED_TOL = 1e-3
# R40 AP (percent) of the kernel run vs the plain-op run on the same weights:
# the decoded rows differ by about 1e-4, which moves a detection across an
# IoU threshold or a score across another only at a near-tie; one such flip
# among the 16 frames' objects moves an AP by well under one point
AP_TOL = 1.0
EVAL_FRAMES = 16           # the 3 fixed scenes of the tree writer + 13 random
EVAL_RUNS = (("a", "pallas3b", False), ("b", "pallas3b", True), ("c", "pallas2p", False),
             ("d", "pallas", False))
# the keys of the R40 AP table the JAX evaluator gives for the three classes
# (the CPU tests hold the port's evaluator to the JAX one's keys and values)
AP_KEYS = sorted(
    f"{cls}_{kind}/{diff}"
    for cls, overlaps in (("Car", ("0.70", "0.50")), ("Pedestrian", ("0.50", "0.25")),
                          ("Cyclist", ("0.50", "0.25")))
    for kind in ["aos", "image"] + [f"{m}_{o}" for m in ("3d", "bev") for o in overlaps]
    for diff in ("easy", "moderate", "hard"))
# published peaks of one H100 SXM (NVIDIA's data sheet): f32 outside the
# tensor cores, the type of every kernel's arithmetic, and HBM bandwidth
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


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


def dcn_work(kind: str, H: int, W: int, C: int, Co: int, x_bytes: int):
    """(operations, bytes) one DCN kernel call needs at batch BATCH: each
    input read once, each output written once.  Operations: the 9*C*Co
    contraction per pixel (2 each, multiply and add), 8 per sampled
    (pixel, tap, channel) for the 4 bilinear corners; dwmo also forms
    u = W g, samples the two offset derivatives and takes 3 channel dots;
    the epilogue adds 3 per output (scale, shift, max)."""
    n = BATCH * H * W
    taps = 9 * n * C
    gemm = 2 * taps * Co
    f32 = 4
    offset_mask = n * 27 * f32
    weight = 9 * C * Co * f32
    if kind == "fwd":
        return gemm + 8 * taps, n * C * x_bytes + offset_mask + weight + Co * f32 + n * Co * f32
    if kind == "fwd_bn_relu":
        return (gemm + 8 * taps + 3 * n * Co,
                n * C * x_bytes + offset_mask + weight + 2 * Co * f32 + n * Co * f32)
    if kind == "dx":   # x is not read: dx does not depend on it
        return gemm + 8 * taps, offset_mask + weight + n * Co * f32 + n * C * f32
    if kind == "dwmo":  # outputs dmask, doffset and dW
        return (2 * gemm + 30 * taps,
                n * C * x_bytes + offset_mask + weight + n * Co * f32 + offset_mask + weight)
    raise ValueError(kind)


def bound_of(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations over the f32 peak
    and the bytes over the memory rate."""
    t_ops, t_bytes = ops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_kernel() -> dict:
    """dcn_fwd against the plain op at the neck's shapes, x in bf16 (the
    default impl); the kernel is also timed with x in f32, the transfer of
    the pallas3, pallas2, pallas2p and pallas impls."""
    worst = 0.0
    ms_fwd = plain_fwd = f32_fwd = 0.0
    ops = nbytes = 0
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

        def kernel_f32():
            return dcn_cuda.dcn_forward(*args, max_offset=R, transfer_dtype=torch.float32)

        y = kernel()
        err = (y - plain()).abs().max().item()
        if not (err <= KERNEL_TOL and torch.isfinite(y).all()):
            raise AssertionError(f"dcn_fwd {(BATCH, H, W, C, Co)}: max abs err {err} > {KERNEL_TOL}")
        # plain, kernel, kernel, plain: drift in clocks hits both sides alike
        p1, k1, f1, f2, k2, p2 = (time_ms(plain, 5), time_ms(kernel, 20), time_ms(kernel_f32, 20),
                                  time_ms(kernel_f32, 20), time_ms(kernel, 20), time_ms(plain, 5))
        k_ms, p_ms, f_ms = (k1 + k2) / 2, (p1 + p2) / 2, (f1 + f2) / 2
        worst = max(worst, err)
        ms_fwd += layers * k_ms
        plain_fwd += layers * p_ms
        f32_fwd += layers * f_ms
        work = dcn_work("fwd", H, W, C, Co, x.element_size())
        ops, nbytes = ops + layers * work[0], nbytes + layers * work[1]
        phase("kernel", f"dcn_fwd B,H,W,C,Co={(BATCH, H, W, C, Co)} layers={layers} "
                        f"max_abs_err={err:.3e} (tol {KERNEL_TOL}) kernel_ms={k_ms:.4f} "
                        f"plain_ms={p_ms:.4f} kernel_f32x_ms={f_ms:.4f}")
        del x, off, mask, w, b, args, y
    torch.cuda.empty_cache()
    bound_ms, bound_by = bound_of(ops, nbytes)
    phase("kernel", f"per forward (16 layers): kernel_ms={ms_fwd:.4f} plain_ms={plain_fwd:.4f} "
                    f"kernel_f32x_ms={f32_fwd:.4f} "
                    f"bound_ms={bound_ms:.4f} ({bound_by}: {ops / 1e9:.1f} GFLOP, "
                    f"{nbytes / 1e9:.3f} GB)")
    return {"max_abs_err": worst, "ms": ms_fwd, "plain_ms": plain_fwd, "bound_ms": bound_ms,
            "bound_by": bound_by}


@torch.no_grad()
def perturb_offset_convs(model: torch.nn.Module, seed: int, weight_scale: float = 2.0) -> None:
    """The offset/mask convs start at zero (no deformation).  Give them
    seeded weights so offsets are fractional and some pass +-R."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, DCN):
            conv = m.conv_offset_mask
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g)
                              * weight_scale / fan_in ** 0.5)
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=g))


@torch.no_grad()
def perturb_bn(model: torch.nn.Module, seed: int) -> None:
    """Every BN starts as the identity and the DCN biases at zero, where a
    folded epilogue equals the unfused BN bit for bit.  Give them seeded
    values so the fold (scale, shift and the bias in it) is exercised."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, DCN):
            m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
        elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.weight.copy_(1 + torch.randn(m.weight.shape, generator=g) * 0.1)
            m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
            m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))


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


def check_backward() -> dict:
    """dcn_bwd_dx and dcn_bwd_dwmo against the plain backward at the neck's
    shapes; ms per call, each kernel against the plain backward of the same
    outputs, timed in turns."""
    worst = {"dx": 0.0, "dwmo": 0.0}
    step_ms = {"dx": 0.0, "dwmo": 0.0, "plain_dx": 0.0, "plain_dwmo": 0.0, "dwmo_f32x": 0.0}
    work = {"dx": [0, 0], "dwmo": [0, 0]}
    for i, ((H, W, C, Co), layers) in enumerate(DCN_SHAPES):
        if layers == 0:
            continue
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        x = torch.randn(BATCH, H, W, C, device="cuda", generator=g).to(torch.bfloat16)
        off = torch.randn(BATCH, H, W, 18, device="cuda", generator=g) * 1.5
        mask = torch.rand(BATCH, H, W, 9, device="cuda", generator=g)
        w = torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5
        gy = torch.randn(BATCH, H, W, Co, device="cuda", generator=g)
        args = (x, off, mask, w, gy)

        def kernel_dx():
            return dcn_cuda.dcn_bwd_dx(*args, max_offset=R)

        def kernel_dwmo():
            return dcn_cuda.dcn_bwd_dwmo(*args, max_offset=R)

        def plain(wrt):
            return lambda: modulated_deform_conv_backward(x.float(), off, mask, w, gy,
                                                          max_offset=R, wrt=wrt)

        plain_dx, plain_dwmo = plain(("x",)), plain(("offset", "mask", "weight"))
        dx = kernel_dx()
        dmask, dw, doff = kernel_dwmo()
        rdx, rdoff, rdmask, rdw, _ = modulated_deform_conv_backward(
            x.float(), off, mask, w, gy, max_offset=R)
        errs = {}
        for key, got, ref in (("dx", dx, rdx), ("dmask", dmask, rdmask),
                              ("doffset", doff, rdoff), ("dW", dw, rdw)):
            errs[key] = (got - ref).abs().max().item()
            bound = BWD_RTOL * ref.abs().max().item()
            if not (errs[key] <= bound and torch.isfinite(got).all()):
                raise AssertionError(f"{key} {(BATCH, H, W, C, Co)}: max abs err {errs[key]} "
                                     f"> {bound} ({BWD_RTOL} of max |ref|)")
        worst["dx"] = max(worst["dx"], errs["dx"])
        worst["dwmo"] = max(worst["dwmo"], errs["dmask"], errs["doffset"], errs["dW"])
        del dx, dmask, dw, doff, rdx, rdoff, rdmask, rdw
        times = {}
        for name, kern, ref in (("dx", kernel_dx, plain_dx), ("dwmo", kernel_dwmo, plain_dwmo)):
            p1, k1, k2, p2 = (time_ms(ref, 3), time_ms(kern, 10), time_ms(kern, 10),
                              time_ms(ref, 3))
            times[name], times["plain_" + name] = (k1 + k2) / 2, (p1 + p2) / 2
        # dwmo reads x, so its time depends on the transfer dtype (f32 under
        # the pallas3, pallas2, pallas2p and pallas impls); dx does not read x
        xf = x.float()
        times["dwmo_f32x"] = sum(
            time_ms(lambda: dcn_cuda.dcn_bwd_dwmo(xf, off, mask, w, gy, max_offset=R), 10)
            for _ in range(2)) / 2
        del xf
        for key, ms in times.items():
            step_ms[key] += layers * ms
        for name in work:
            ops, nbytes = dcn_work(name, H, W, C, Co, x.element_size())
            work[name][0] += layers * ops
            work[name][1] += layers * nbytes
        phase("bwd", f"B,H,W,C,Co={(BATCH, H, W, C, Co)} layers={layers} "
                     + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items())
                     + f" (tol {BWD_RTOL} of max |ref|) "
                     + " ".join(f"{k}_ms={v:.4f}" for k, v in times.items()))
        del x, off, mask, w, gy, args
        torch.cuda.empty_cache()
    out = {}
    for name in ("dx", "dwmo"):
        bound_ms, bound_by = bound_of(*work[name])
        out[name] = {"max_abs_err": worst[name], "ms": step_ms[name],
                     "plain_ms": step_ms["plain_" + name], "bound_ms": bound_ms,
                     "bound_by": bound_by}
    phase("bwd", "per step (16 layers): " + " ".join(f"{k}_ms={v:.4f}" for k, v in step_ms.items())
          + " " + " ".join(f"{k}_bound_ms={v['bound_ms']:.4f} ({v['bound_by']}: "
                           f"{work[k][0] / 1e9:.1f} GFLOP, {work[k][1] / 1e9:.3f} GB)"
                           for k, v in out.items()))
    return out


def feeds_train_bn(name: str) -> bool:
    """A bias whose conv output goes straight into a train-mode BN."""
    return name.endswith("conv.bias") and ".conv_offset_mask." not in name or (
        name.startswith("heads.predictor.trunc_") and name.endswith(".0.bias"))


def compare_steps(state: dict, cfg, batch: dict) -> dict:
    """One kernel step and one plain-op step from the same saved state, x in
    f32: the total loss and every parameter's gradient."""
    cfg = cfg.clone()
    cfg.TPU.DCN_FORCE_IMPL = "pallas3"
    grads, totals = {}, {}
    for label, use_kernel in (("kernel", True), ("plain", False)):
        model = build_model(cfg, device="cuda", use_dcn_kernel=use_kernel)
        model.load_state_dict(state)
        totals[label] = forward_backward(model, LossComputer(cfg), batch)[0].item()
        grads[label] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        del model
    if grads["kernel"].keys() != grads["plain"].keys():
        raise AssertionError("the kernel and plain-op steps reach different parameters")
    loss_err = abs(totals["kernel"] - totals["plain"]) / abs(totals["plain"])
    top = max(g.abs().max().item() for g in grads["plain"].values())
    worst_rel, worst_zero = 0.0, 0.0
    for name, ref in grads["plain"].items():
        got = grads["kernel"][name]
        if not torch.isfinite(got).all():
            raise AssertionError(f"gradient of {name} is not finite")
        if feeds_train_bn(name):
            worst_zero = max(worst_zero, got.abs().max().item(), ref.abs().max().item())
        elif ref.norm() > 0:
            rel = ((got - ref).norm() / ref.norm()).item()
            if rel > worst_rel:
                worst_rel, worst_name = rel, name
    phase("train", f"kernel step vs plain-op step: total {totals['kernel']:.6f} vs "
                   f"{totals['plain']:.6f} (rel {loss_err:.3e}, tol {STEP_LOSS_RTOL}); "
                   f"worst gradient rel L2 {worst_rel:.3e} ({worst_name}; tol {STEP_GRAD_REL_L2}) "
                   f"over {len(grads['plain'])} parameters; biases into train-mode BN "
                   f"{worst_zero:.3e} (tol {ZERO_GRAD_RTOL} x {top:.3e})")
    if not (loss_err <= STEP_LOSS_RTOL and worst_rel <= STEP_GRAD_REL_L2
            and worst_zero <= ZERO_GRAD_RTOL * top):
        raise AssertionError("the kernel step and the plain-op step disagree")
    return {"loss_rel_err": loss_err, "grad_rel_l2": worst_rel}


def run_train(card: str) -> dict:
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
    model = build_model(cfg, device="cuda", seed=0)
    # milder than the inference slice's: offsets still fractional and partly
    # clamped, but through 16 deformable layers in train mode the larger
    # weights make the gradient explode, which no kernel comparison survives
    perturb_offset_convs(model, seed=1, weight_scale=0.2)
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_train_batch(BATCH).items()}
    optimizer, _, _ = build_optimizer(cfg, model)
    train_step = make_train_step(model, LossComputer(cfg), optimizer)
    watched = ["backbone.base.base_layer.0.weight", "backbone.dla_up.ida_0.proj_1.conv.weight",
               "backbone.dla_up.ida_0.proj_1.conv.conv_offset_mask.weight"]
    params = dict(model.named_parameters())
    start = {n: params[n].detach().clone() for n in watched}

    stats, handles = offset_stats(model)
    state, metrics = train_step(TrainState(), batch)          # warm-up
    for h in handles:
        h.remove()
    torch.cuda.synchronize()
    counters = (dcn_cuda.dcn_forward, dcn_cuda.dcn_bwd_dx, dcn_cuda.dcn_bwd_dwmo)
    for f in counters:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = 3
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for name, n in launches.items():
        if n != 16 * steps:
            raise AssertionError(f"{n} {name} launches in {steps} steps, want {16 * steps}")
    terms = cfg.MODEL.HEAD.LOSS_NAMES
    values = {k: float(metrics[k]) for k in list(terms) + ["total_loss"]}
    bad = [k for k, v in values.items() if not torch.isfinite(torch.tensor(v))]
    if len(terms) != 11 or bad or metrics["skipped"] != 0.0 or state.skips != 0:
        raise AssertionError(f"non-finite terms {bad}, skipped {metrics['skipped']}")
    still = [n for n in watched if torch.equal(params[n].detach(), start[n])]
    if still:
        raise AssertionError(f"parameters did not move: {still}")
    clamped = sum(s[0] for s in stats) / len(stats)
    fractional = sum(s[1] for s in stats) / len(stats)
    phase("train", f"{steps} steps at batch {BATCH}, 384x1280: {BATCH * steps / elapsed:.2f} img/s, "
                   f"peak {peak_gb:.2f} GB on {card}; launches "
                   + " ".join(f"{k}={v}" for k, v in launches.items())
                   + f"; total_loss {values['total_loss']:.4f}, 11 terms finite, skipped 0; "
                   f"offsets {clamped:.3f} of |o| > R, {fractional:.3f} fractional; "
                   f"moved: {', '.join(watched)}")
    phase("train", "terms: " + " ".join(f"{k}={v:.4f}" for k, v in values.items()))
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    del model, optimizer, train_step, params, start
    torch.cuda.empty_cache()
    compare_steps(state_dict, cfg, batch)
    return {"launches": launches}


def check_epilogue() -> dict:
    """dcn_fwd with the fused BN+ReLU epilogue against its plain version at
    the neck's shapes, batch 8, R=2, x in bf16 (as the served model feeds
    it), BN from seeded statistics with the conv bias folded into the shift;
    ms per call of the fused kernel, the plain fused op, and the unfused
    path it replaces (dcn_fwd, then BatchNorm and ReLU), timed in turns."""
    worst = worst_unfused = 0.0
    total = {"ms": 0.0, "plain_ms": 0.0, "unfused_ms": 0.0}
    ops = nbytes = 0
    for i, ((H, W, C, Co), layers) in enumerate(DCN_SHAPES):
        if layers == 0:
            continue
        g = torch.Generator(device="cuda").manual_seed(200 + i)
        x = torch.randn(BATCH, H, W, C, device="cuda", generator=g)
        off = torch.randn(BATCH, H, W, 18, device="cuda", generator=g) * 1.5
        mask = torch.rand(BATCH, H, W, 9, device="cuda", generator=g)
        w = torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5
        b = torch.randn(Co, device="cuda", generator=g) * 0.1
        gamma = 1 + 0.1 * torch.randn(Co, device="cuda", generator=g)
        beta = 0.1 * torch.randn(Co, device="cuda", generator=g)
        mean = 0.1 * torch.randn(Co, device="cuda", generator=g)
        var = 0.5 + torch.rand(Co, device="cuda", generator=g)
        scale = gamma * torch.rsqrt(var + BN_EPS)
        shift = beta - mean * scale + b * scale
        kw = dict(max_offset=R, transfer_dtype=torch.bfloat16)

        def kernel():
            return dcn_cuda.dcn_forward_bn_relu(x, off, mask, w, scale, shift, **kw)

        def plain():
            return modulated_deform_conv_bn_relu(x, off, mask, w, scale, shift, **kw)

        def unfused():
            y = dcn_cuda.dcn_forward(x, off, mask, w, b, **kw).permute(0, 3, 1, 2)
            return torch.relu(F.batch_norm(y, mean, var, gamma, beta, False, 0.0, BN_EPS))

        with torch.inference_mode():
            y = kernel()
            err = (y - plain()).abs().max().item()
            err_unfused = (y - unfused().permute(0, 2, 3, 1)).abs().max().item()
            if not (err <= KERNEL_TOL and err_unfused <= KERNEL_TOL and torch.isfinite(y).all()):
                raise AssertionError(f"dcn_fwd_bn_relu {(BATCH, H, W, C, Co)}: max abs err "
                                     f"{err} vs plain, {err_unfused} vs unfused > {KERNEL_TOL}")
            p1, k1, u1, u2, k2, p2 = (time_ms(plain, 5), time_ms(kernel, 20),
                                      time_ms(unfused, 20), time_ms(unfused, 20),
                                      time_ms(kernel, 20), time_ms(plain, 5))
        times = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "unfused_ms": (u1 + u2) / 2}
        for key, ms in times.items():
            total[key] += layers * ms
        worst, worst_unfused = max(worst, err), max(worst_unfused, err_unfused)
        work = dcn_work("fwd_bn_relu", H, W, C, Co, x.element_size())
        ops, nbytes = ops + layers * work[0], nbytes + layers * work[1]
        phase("eval", f"dcn_fwd_bn_relu B,H,W,C,Co={(BATCH, H, W, C, Co)} layers={layers} "
                      f"max_abs_err={err:.3e} (vs dcn_fwd+BN+ReLU {err_unfused:.3e}; tol "
                      f"{KERNEL_TOL}) " + " ".join(f"{k}={v:.4f}" for k, v in times.items()))
        del x, off, mask, w, b, y
    torch.cuda.empty_cache()
    bound_ms, bound_by = bound_of(ops, nbytes)
    phase("eval", "dcn_fwd_bn_relu per forward (16 layers): "
                  + " ".join(f"{k}={v:.4f}" for k, v in total.items())
                  + f" bound_ms={bound_ms:.4f} ({bound_by}: {ops / 1e9:.1f} GFLOP, "
                    f"{nbytes / 1e9:.3f} GB)")
    return {"max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by}


def eval_cfg(out_dir: str, impl: str, fuse: bool):
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
    cfg.DATASETS.TEST_SPLIT = "trainval"
    cfg.TEST.IMS_PER_BATCH = BATCH
    cfg.TEST.DETECTIONS_THRESHOLD = 0.0       # every one of the 50 rows reaches the txts
    cfg.TPU.DCN_FORCE_IMPL = impl
    cfg.TPU.DCN_FUSE_BN_RELU = fuse
    cfg.DATALOADER.NUM_WORKERS = 4
    cfg.OUTPUT_DIR = out_dir
    return cfg


def model_from(cfg, state: dict, use_kernel: bool = True) -> torch.nn.Module:
    model = build_model(cfg, use_dcn_kernel=use_kernel)
    model.load_state_dict(state)
    return model


def head_maps(model: torch.nn.Module, batch: dict) -> dict:
    model.eval()
    with torch.inference_mode():
        return model(batch["image"], batch["edge_indices"], batch["edge_len"])


def check_ap(label: str, ap: dict, pred_dir: str) -> None:
    txts = [f for f in os.listdir(pred_dir) if f.endswith(".txt")]
    if len(txts) != EVAL_FRAMES:
        raise AssertionError(f"({label}) {len(txts)} txt files in {pred_dir}, want {EVAL_FRAMES}")
    keys = sorted(k for k in ap if k not in ("images", "s_per_img"))
    if keys != AP_KEYS:
        raise AssertionError(f"({label}) AP keys {keys} differ from the evaluator's {AP_KEYS}")
    bad = [k for k in keys if not math.isfinite(float(ap[k]))]
    if bad:
        raise AssertionError(f"({label}) AP not finite: {bad}")


def run_eval() -> dict:
    """The evaluation entry points on a seeded KITTI-format tree; returns the
    launch counts of the fused run."""
    counters = (dcn_cuda.dcn_forward, dcn_cuda.dcn_forward_bn_relu)
    forwards = math.ceil(EVAL_FRAMES / BATCH)
    with tempfile.TemporaryDirectory(prefix="monoflex_eval_") as tmp:
        t0 = time.perf_counter()
        root = make_synthetic_kitti(os.path.join(tmp, "kitti", "training"),
                                    n_random_frames=EVAL_FRAMES - 3, render=True)
        base = eval_cfg(tmp, "pallas3b", False)
        dataset = KITTIDataset(base, root, is_train=False)
        if len(dataset) != EVAL_FRAMES:
            raise AssertionError(f"{len(dataset)} frames in the trainval split")
        seeded = build_model(base, seed=0)
        perturb_offset_convs(seeded, seed=1)
        perturb_bn(seeded, seed=2)
        state = {k: v.clone() for k, v in seeded.state_dict().items()}
        del seeded
        probe = to_device(next(iter(make_test_loader(base, dataset))), "cuda")
        phase("eval", f"tree of {EVAL_FRAMES} frames (1242x375, trainval) written and "
                      f"encoded in {time.perf_counter() - t0:.2f} s")

        heads, aps, launches = {}, {}, {}
        for label, impl, fuse in EVAL_RUNS:
            cfg = eval_cfg(os.path.join(tmp, label), impl, fuse)
            model = model_from(cfg, state)
            eval_step = make_eval_step(model, PostProcessor(cfg))
            out_dir = os.path.join(cfg.OUTPUT_DIR, "inference")
            for f in counters:
                f.launches = 0
            t0 = time.perf_counter()
            aps[label] = inference(cfg, eval_step, dataset, out_dir, metrics=("R40",))
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launches[label] = {f.__name__: f.launches for f in counters}
            want = ({"dcn_forward": 0, "dcn_forward_bn_relu": 16 * forwards} if fuse else
                    {"dcn_forward": 16 * forwards, "dcn_forward_bn_relu": 0})
            if launches[label] != want:
                raise AssertionError(f"({label}) launches {launches[label]} in {forwards} "
                                     f"forwards, want {want}")
            check_ap(label, aps[label], os.path.join(out_dir, "data"))
            heads[label] = head_maps(model, probe)
            del model
            plain = model_from(cfg, state, use_kernel=False)
            err = max_head_err(heads[label], head_maps(plain, probe))
            if label == "a":
                aps["plain"] = inference(cfg, make_eval_step(plain, PostProcessor(cfg)), dataset,
                                         os.path.join(tmp, "plain", "inference"),
                                         metrics=("R40",))
            del plain
            if not err <= HEADS_TOL:
                raise AssertionError(f"({label}) head maps vs plain op differ by {err} > {HEADS_TOL}")
            torch.cuda.empty_cache()
            phase("eval", f"({label}) {impl}{' + fused BN+ReLU' if fuse else ''}: inference() "
                          f"on {EVAL_FRAMES} images in {elapsed:.2f} s, "
                          f"{1 / aps[label]['s_per_img']:.2f} img/s for the eval step with its "
                          f"host transfers; launches per forward "
                          + " ".join(f"{k}={v // forwards}" for k, v in launches[label].items())
                          + f"; 16 txts, {len(AP_KEYS)} finite R40 APs "
                          f"(Car_3d_0.70/moderate {aps[label]['Car_3d_0.70/moderate']:.4f}); "
                          f"head maps vs plain op {err:.3e}")

        fused_err = max_head_err(heads["a"], heads["b"])
        ap_err = max(abs(float(aps["a"][k]) - float(aps["plain"][k])) for k in AP_KEYS)
        phase("eval", f"head maps fused vs unfused (both kernels) {fused_err:.3e} (tol "
                      f"{FUSED_TOL}); R40 AP kernel vs plain op max |diff| {ap_err:.4f} "
                      f"(tol {AP_TOL})")
        if not (fused_err <= FUSED_TOL and ap_err <= AP_TOL):
            raise AssertionError("the fused model or the AP table disagrees")

        cfg = eval_cfg(os.path.join(tmp, "sweep"), "pallas3b", False)
        model = model_from(cfg, state)
        eval_step = make_eval_step(model, PostProcessor(cfg))
        dcn_cuda.dcn_forward.launches = 0
        t0 = time.perf_counter()
        sweep = inference_all_depths(cfg, eval_step, dataset,
                                     os.path.join(cfg.OUTPUT_DIR, "inference"))
        sweep_s = time.perf_counter() - t0
        if sorted(sweep) != sorted(["direct", "keypoints_center", "keypoints_02",
                                    "keypoints_13", "hard", "soft", "mean", "oracle"]):
            raise AssertionError(f"depth sweep modes {sorted(sweep)}")
        for mode, ap in sweep.items():
            check_ap(mode, ap, os.path.join(cfg.OUTPUT_DIR, "inference", f"depth_{mode}", "data"))
        if dcn_cuda.dcn_forward.launches != 16 * forwards * len(sweep):
            raise AssertionError(f"{dcn_cuda.dcn_forward.launches} dcn_fwd launches in the sweep")
        test = run_test(cfg, eval_step, dataset)
        check_ap("run_test", test, os.path.join(cfg.OUTPUT_DIR, "inference_test", "data"))
        cfg.TEST.EVAL_DEPTH = cfg.TEST.EVAL_DIS_IOUS = True
        diag = run_diagnostics(cfg, model, make_test_loader(cfg, dataset),
                               logging.getLogger("chip_smoke"))
        if len(diag) != 17 or not all(math.isfinite(v) for v in diag.values()):
            raise AssertionError(f"diagnostics {diag}")
        phase("eval", f"inference_all_depths: 8 modes in {sweep_s:.2f} s, each 16 txts and "
                      f"finite APs (Car_3d_0.70/moderate "
                      + " ".join(f"{m}={ap['Car_3d_0.70/moderate']:.4f}" for m, ap in sweep.items())
                      + "); run_test: 16 txts, finite APs; diagnostics: 17 finite means "
                      f"(depth_err/direct {diag['depth_err/direct']:.4f}, dis_iou/pred_IoU "
                      f"{diag['dis_iou/pred_IoU']:.4f})")
    return launches["b"]


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
    phase("build", f"{', '.join(src.name for src in dcn_cuda.SOURCES)} -> sm_90a in "
                   f"{time.perf_counter() - t0:.2f} s")

    fwd = check_kernel()
    slice_launches = run_slice()["launches"]
    bwd = check_backward()
    train = run_train(card)
    epilogue = check_epilogue()
    fused_launches = run_eval()
    phase("report", f"inference slice dcn_fwd launches {slice_launches}; the kernels line "
                    f"counts the train phase's launches, and the fused eval run's for "
                    f"dcn_fwd_bn_relu")

    kernels = [
        dict(name="dcn_fwd", source="monoflex_tpu_torch/csrc/dcn_fwd.cu",
             replaces="monoflex_tpu/ops/dcn_pallas_v3.py:155", **fwd),
        dict(name="dcn_bwd_dx", source="monoflex_tpu_torch/csrc/dcn_bwd_dx.cu",
             replaces="monoflex_tpu/ops/dcn_pallas_v3.py:598", **bwd["dx"]),
        dict(name="dcn_bwd_dwmo", source="monoflex_tpu_torch/csrc/dcn_bwd_dwmo.cu",
             replaces="monoflex_tpu/ops/dcn_pallas_v3.py:747", **bwd["dwmo"]),
        dict(name="dcn_fwd_bn_relu", source="monoflex_tpu_torch/csrc/dcn_fwd.cu",
             replaces="monoflex_tpu/ops/dcn_pallas_v3.py:155 (epilogue)", **epilogue),
    ]
    launches = {**{{"dcn_forward": "dcn_fwd"}.get(k, k): v for k, v in train["launches"].items()},
                "dcn_fwd_bn_relu": fused_launches["dcn_forward_bn_relu"]}
    # no single PyTorch call computes a modulated deformable conv (torchvision,
    # which has one, is not installed on the card's machine)
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": launches[k["name"]], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": None}
        for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
