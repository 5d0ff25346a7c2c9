#!/usr/bin/env python3
"""Drive the PyTorch port's inference and training paths once on one NVIDIA
GPU.

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
  7. report  the kernels' JSON line, the card line, and last the result line
             {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.synthetic import make_inference_batch, make_train_batch
from monoflex_tpu_torch.decode.postprocessor import PostProcessor
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.models.backbone.dla import DCN
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import modulated_deform_conv, modulated_deform_conv_backward
from monoflex_tpu_torch.train.solver import build_optimizer
from monoflex_tpu_torch.train.train_step import TrainState, forward_backward, make_train_step

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
    step_ms = {"dx": 0.0, "dwmo": 0.0, "plain_dx": 0.0, "plain_dwmo": 0.0}
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
        for key, ms in times.items():
            step_ms[key] += layers * ms
        phase("bwd", f"B,H,W,C,Co={(BATCH, H, W, C, Co)} layers={layers} "
                     + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items())
                     + f" (tol {BWD_RTOL} of max |ref|) "
                     + " ".join(f"{k}_ms={v:.4f}" for k, v in times.items()))
        del x, off, mask, w, gy, args
        torch.cuda.empty_cache()
    phase("bwd", "per step (16 layers): " + " ".join(f"{k}_ms={v:.4f}" for k, v in step_ms.items()))
    return {name: {"max_abs_err": worst[name], "ms": step_ms[name],
                   "plain_ms": step_ms["plain_" + name]} for name in ("dx", "dwmo")}


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
    phase("report", f"inference slice dcn_fwd launches {slice_launches}; the kernels line "
                    f"counts the train phase's launches")

    kernels = [
        dict(name="dcn_fwd", source="monoflex_tpu_torch/csrc/dcn_fwd.cu",
             replaces="monoflex_tpu/ops/dcn_pallas_v3.py:155", **fwd),
        dict(name="dcn_bwd_dx", source="monoflex_tpu_torch/csrc/dcn_bwd_dx.cu",
             replaces="monoflex_tpu/ops/dcn_pallas_v3.py:598", **bwd["dx"]),
        dict(name="dcn_bwd_dwmo", source="monoflex_tpu_torch/csrc/dcn_bwd_dwmo.cu",
             replaces="monoflex_tpu/ops/dcn_pallas_v3.py:747", **bwd["dwmo"]),
    ]
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": train["launches"][{"dcn_fwd": "dcn_forward"}.get(k["name"], k["name"])],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"]}
        for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
