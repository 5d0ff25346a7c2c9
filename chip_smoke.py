#!/usr/bin/env python3
"""Drive the PyTorch port's inference, training, evaluation and
kernel-diagnostics paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:
  1. device  CUDA is required (there is no CPU path); the card's name and
             power limit as nvidia-smi reports them.
  2. build   compile every monoflex_tpu_torch/csrc/*.cu for sm_90a, one nvcc
             each, all started together.
  3. kernel  the DCNv2 forward kernel against the plain PyTorch op at the
             neck's DCN shapes, batch 8, R=2, x in bf16: max abs error
             against the tolerance, ms per call of each, the tile of output
             channels (wide_launches counted where it is 256); then the same
             at batch 1 (a stream's frame) and at FCOS3D's six DCN shapes
             (MODEL.META_ARCHITECTURE "FCOSMono3D" at 1600x900), batch 6;
             then the multi-scale deformable attention kernel (msda_fwd)
             against its plain op at BEVFormer-base's three families (2 BEV
             queues of 200x200; six cameras' P3-P6 with the benchmark rig's
             visibility mask; 900 decoder queries), bf16 values: error of
             the RMS against the tolerance, two launches bit-equal, ms of
             each beside the call's bound (mfbench/work_bevformer.py).
  4. slice   runs/monoflex.yaml at 384x1280, batch 8, seeded weights with the
             offset/mask convs perturbed off zero: one warm-up, then 3
             forward+decode passes that must launch the kernel 16 times each
             and give finite (8, 50, 14) rows; the head maps against the same
             model on the plain op (bf16 x as served, and f32 x).
  5. bwd     the two backward kernels (dx; dmask, dW and doffset) against
             the plain backward at the neck's shapes, batch 8, R=2, x in
             bf16: max errors against the tolerances, each kernel's two
             launches bit-equal, ms per call of each; then dx at R=8, the
             first stage's clamp under TPU.DCN_MAX_OFFSET_PER_STAGE = (8, 4,
             2, 2), at that stage's two shapes, the same way; then dx at
             R=16, past the reach of its halo of g (its wide path), at the
             first of them, the same way, beside its bound.
  6. train   the training step on the same model and batch size: one
             warm-up step, then 3 steps that must launch each of the three
             kernels 16 times per step, give 11 finite loss terms and no
             skipped step, and move the trunk's first conv, a DCN weight and
             an offset/mask conv; then, from one saved state, the loss and
             every gradient of a kernel step against a plain-op step, and
             again under the per-stage clamp (8, 4, 2, 2), whose kernel step
             must launch each kernel 16 times.
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
  8. diag    the kernel-diagnostics path: each dcn_ablate variant against
             its plain version at kernel_diag's default shapes (0 and 4 of
             MODEL_SHAPES), with dcn_fwd timed beside them (the split of its
             time) and x.clone() and F.conv2d (nomap as one convolution)
             beside dma and nomap, all timed in CUDA graphs over input
             copies of twice the L2 (none may read below its bound); the relayout
             kernel against its plain version and
             F.pad(x.permute(...)) at transpose_ablate's default shape; the
             bf16 window math of dcn_fwd, dcn_bwd_dx and dcn_bwd_dwmo against
             the plain op at the neck's shapes (dx twice bit-equal); then
             the four tools through their entry points
             (python -m monoflex_tpu_torch.tools.<tool>),
             each a process whose launch counts start at 0 and are written
             at its end: kernel_bench (f32r2,bf16r1, all shapes, --bwd),
             kernel_diag at its defaults, fwd_ablate --parity with every
             variant, transpose_ablate with every variant.  Fails on a
             non-zero exit, an error record, a non-finite time or a parity
             error above tolerance.
  9. configs every model configuration beyond the slice's, at full width,
             batch 8, 384x1280, seeded weights: runs/monoflex_bf16.yaml
             (TPU.COMPUTE_DTYPE bfloat16, pallas3b) forward+decode on the
             kernels against the same bf16 model on the plain op, its img/s
             over 10 passes beside the f32 model's in the same call, a
             device split of one pass of each, 5 training steps (16 launches
             of each kernel a step, 11 finite terms, no skip, peak memory)
             and the kernel step against the plain step with the BN
             statistics fixed, beside the plain step against itself; the
             unbounded "gather" impl (plain PyTorch,
             the port of the JAX package's XLA op) against pallas3 with every
             offset inside R and with most beyond it, and a mixed neck
             ("gather" on ida_0) launching dcn_fwd 14 times a forward; the
             offset guard under "auto" rerouting saturated ida_0 weights to
             gather, and the rerouted model's forward; then dla34_nodcn, GN
             heads, dlav0, dlav0_dla169 and the bf16 model on "shift", one
             checked forward each and timed (without cuDNN's autotune).
 10. trainer the training entry point, python -m monoflex_tpu_torch.cli, as
             processes on the card: runs/monoflex_ema.yaml at 384x1280,
             batch 8, on the phase's own 16-frame 1242x375 tree (splits
             trainval): 20 iterations with a checkpoint at 10, an eval of
             the EMA weights at 20 and --profile 5; then --eval --ckpt
             model_final_ema; then a resume to 30 from last_checkpoint under
             --num_processes 1 --process_id 0 --coordinator_address, so NCCL
             and DistributedDataParallel run at world size 1 (these two
             without cuDNN's autotune: checked, not timed).  Each process
             writes its launch counts (MONOFLEX_TORCH_LAUNCH_LOG): 16 of each
             DCN kernel per iteration and per eval forward.  Checks: 11
             finite terms, no skip (the optimizer's count equals the
             iteration), "resumed from iteration 20" with count 20, 16 txts
             from the eval.  Prints the loop's img/s, its time and data
             meters and the device idle share of the profile window.
 11. modules the port's counterparts of the JAX package's last modules, on
             the card: the C++ KITTI evaluator against the numpy one (equal
             APs on a 40-frame rendered tree with perturbed ground truth as
             detections, seconds of each); inference(visualize=True) at
             384x1280 writing one PNG an image (at most 8); a reference-format
             .pth of a seeded full-width model loaded into another
             (utils/weight_import.py), the batch-8 forward bit-equal;
             dryrun_multichip(1) over NCCL; then as processes a 100-iteration
             convergence_run on its own 1/4-scale rendered tree (one eval,
             its table, the CLI's time an iteration at 96x320, batch 4),
             offset_stats on its checkpoint and flops; PSROI pooling on the card against the CPU.
 12. bench   the benchmark entry points, as processes at their defaults:
             python -m monoflex_tpu_torch.bench and
             python -m monoflex_tpu_torch.tools.benchmark_train, each in f32
             and with BENCH_DTYPE=bfloat16; each last line must be the JAX
             line (its four keys, a finite positive value, vs_baseline over
             its baseline) and each run must launch each DCN kernel 16 times
             a call, warm-up included (MONOFLEX_TORCH_LAUNCH_LOG); then
             entry()'s fn in this process (finite (8, 50, 14) rows), and
             kernel_sweep (shape 0, f32r2) and bilinear_ablate as processes,
             3 iterations each, every record with finite times.
 13. report  the kernels' JSON line (with each kernel's bound on the card),
             the card line, and last the result line
             {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
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
from monoflex_tpu_torch.ops.dcn_ablate import VARIANTS as ABLATE_VARIANTS
from monoflex_tpu_torch.ops.dcn_ablate import dcn_ablate, dcn_ablate_reference
from monoflex_tpu_torch.ops.relayout import relayout, relayout_dims, relayout_reference
from monoflex_tpu_torch.tools import LAUNCH_LOG_ENV
from monoflex_tpu_torch.tools.ablate_time import diag_inputs, graph_ms, nomap_conv_weight, rotating
from monoflex_tpu_torch.tools.bf16_step_spread import fixed_stats_step, step_distances
from monoflex_tpu_torch.tools.kernel_bench import MODEL_SHAPES
from monoflex_tpu_torch.tools.profile_split import split
from monoflex_tpu_torch.tools.step_drift import perturb_offset_convs, step_drift
from monoflex_tpu_torch.train.solver import build_optimizer
from monoflex_tpu_torch.train.train_step import TrainState, make_eval_step, make_train_step
from monoflex_tpu_torch.utils.dcn_guard import dcn_offset_guard, reroute
from monoflex_tpu_torch.utils.precision import apply_precision, current_precision
from monoflex_tpu_torch.utils.weight_import import load_reference_checkpoint

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
# dcn_fwd's launches on the wide tile (256 output channels a block,
# ops/dcn_cuda.py::fwd_tile_n) in a forward of shapes [((H, W, C, Co), layers)]
def wide_per_forward(shapes) -> int:
    return sum(n for (_, _, _, Co), n in shapes if dcn_cuda.fwd_tile_n(Co) == 256)


# (H, W, C, Co) of FCOS3D's 36 DCNs (a nuScenes sample's six 1600x900 images,
# padded to 928) and how many run at each: stage 3's 23 and the two head
# towers' at P4, stage 4's 3, and the towers' at P3, P5, P6 and P7
FCOS3D_BATCH = 6
FCOS3D_DCN_SHAPES = [
    ((58, 100, 256, 256), 25),
    ((29, 50, 512, 512), 3),
    ((116, 200, 256, 256), 2),
    ((29, 50, 256, 256), 2),
    ((15, 25, 256, 256), 2),
    ((8, 13, 256, 256), 2),
]
# BEVFormer-base (MODEL.META_ARCHITECTURE "BEVFormer") on one nuScenes
# sample, six 1600x900 cameras: its multi-scale deformable attention
# (ops/msda.py) runs 18 times a forward, 6 at each family (the temporal
# self-attention over 2 BEV queues of 200x200, the spatial cross-attention
# over the cameras' P3-P6 with the rig's visibility mask, the decoder's 900
# queries over the BEV); its outputs in bf16 are held to the plain op's f32
# at one bf16 rounding of their RMS (tests/test_torch_msda_cuda.py)
BEV_CAMS, BEV_H, BEV_W = 6, 900, 1600
MSDA_TOL = 2 ** -8
MSDA_PER_FORWARD = 18
BEV_CALLS = (True, False, False, True, False, False, False, False)    # scene starts
# the documented per-stage clamp TPU.DCN_MAX_OFFSET_PER_STAGE (monoflex_tpu/
# config/defaults.py): its first stage, ida_0, runs at R = 8 at these shapes
CLAMP_PER_STAGE = (8, 4, 2, 2)
CLAMP_SHAPES = [(24, 80, 256, 256), (12, 40, 512, 256)]
# a reach beyond dcn_bwd_dx's halo (ceil(R) > DX_MAX_REACH = 11): its wide
# path, at ida_0's first shape
WIDE_R = 16
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
# the diag phase: kernel_diag's default shapes and transpose_ablate's
DIAG_SHAPES = [MODEL_SHAPES[0], MODEL_SHAPES[4]]
RELAYOUT_SHAPE = (BATCH, 96, 320, 64)
# dcn_ablate against its plain version: dma and the relayout move data
# (exact); the others are float32 on both sides, summation order only
ABLATE_RTOL = 1e-5
# the bf16-math kernels against the plain op in bf16 math: both round at
# the same points, so they differ by the order of float32 sums and, rarely,
# a sampled value rounded to the neighbouring bf16; the same kernels in f32
# math lie about 1e-3 of the largest |output| from it (bf16 keeps 8 bits),
# so the tolerance sits between the two: 1e-4 of the largest |output| or
# |gradient|
BF16_RTOL = 1e-4
# fwd_ablate --parity (its relerr, max |diff| / max |ref| against the v2
# route): the f32 routes are dcn_fwd itself on the same inputs (0 expected);
# the bf16 routes are the bf16 window math (within 3e-2, as the CPU tests
# hold the TPU kernels' bf16 math to the port's)
PARITY_F32_TOL = 1e-6
PARITY_BF16_TOL = 3e-2
FWD_ABLATE_VARIANTS = ("full", "nomap", "nobcast", "hoistwx", "fori", "foribf16", "hoist3d",
                       "hoist3dbf16", "packed", "packedbf16", "v15", "v15bf16", "packedh3",
                       "packedh3bf16")
TRANSPOSE_VARIANTS = ("xla", "dot", "pallas", "pallasT")
TOOL_ITERS = 3
# the modules phase: its rendered tree (3 fixture frames and 37 random ones,
# 8 in val), the short convergence run's iterations, and the PSROI pool on
# the card against the CPU (float32 bilinear sums of 16 terms, other order)
MODULES_FRAMES = 40
MODULES_CONV_ITERS = 100
PSROI_ATOL = 1e-5
# the trainer phase: iterations of the first run, its checkpoint interval,
# the resumed run's end, and the steps the first run profiles
TRAINER_ITERS, TRAINER_SAVE, TRAINER_RESUME = 20, 10, 30
TRAINER_PROFILE = 5
# the bench phase's iterations of kernel_sweep and bilinear_ablate
SWEEP_ITERS = 3
# published peaks of one H100 SXM (NVIDIA's data sheet, dense): f32 outside
# the tensor cores, the type of the kernels' arithmetic; bf16 on the tensor
# cores, the type of the bf16 window math's product (bf16 x bf16 summed in
# f32); HBM bandwidth
F32_PEAK_FLOPS = 67e12
BF16_TC_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# bf16 tensor-core passes of an f32-class product of split operands
# (csrc/sm90_mma.cuh): dcn_fwd splits each operand in three parts and takes
# six products (the f32 class), and so do the ablations with its products
# (matmul, nomap, nobcast); dcn_bwd_dwmo and dcn_bwd_dx split in two and take
# three.  Under bf16 window math the function's operands are bf16 and one
# pass computes it; the bound counts that one pass for every kernel, though
# dcn_bwd_dx spends a second on the lo part of its reassociated z
TC_PASSES = {"fwd": 6, "fwd_bn_relu": 6, "dwmo": 3, "dx": 3, "matmul": 6, "nomap": 6,
             "nobcast": 6}


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


def dcn_work(kind: str, H: int, W: int, C: int, Co: int, x_bytes: int, bf16_math: bool = False,
             batch: int = BATCH):
    """(f32 operations, bytes, bf16 tensor-core operations) one DCN kernel
    call needs at ``batch``: each input read once, each output written
    once.  Operations: the 9*C*Co contraction per pixel (2 each, multiply
    and add), 8 per sampled (pixel, tap, channel) for the 4 bilinear
    corners (dx gathers the same 4 corners per source, mirrored); dwmo also
    forms u = W g (a second contraction), samples the two offset
    derivatives and takes 3 channel dots; the epilogue adds 3 per output
    (scale, shift, max).  Every contraction runs on the tensor cores and is
    counted there, at the bf16 rate: an f32-class product as
    TC_PASSES[kind] bf16 passes of split operands, and one pass under
    ``bf16_math``, whose operands are bf16 already.  The
    sampling stays f32.  The ablations (ops/dcn_ablate.py) at R: dma moves
    x; window takes the 4 corners and the tap sum (9 per sampled element),
    aligned 2 row corners (5); matmul, nomap and nobcast take the
    contraction on the tensor cores as dcn_fwd (TC_PASSES), and in f32:
    matmul the mask (1 per sampled element); nomap one box-summed map,
    whose (2R+1)^2 box is separable (2R adds along the row, 2R along the
    column, once per (pixel, channel)); nobcast, since its hat weights are
    constant over a row tile, a row pass and a column pass of 2R+1
    multiply-adds per (pixel, tap, channel), with 11 (2R+1) per (pixel, tap)
    for the hat maps, the mask and the tile maximum."""
    n = batch * H * W
    taps = 9 * n * C
    gemm = 2 * taps * Co
    f32 = 4
    offset_mask = n * 27 * f32
    weight = 9 * C * Co * f32
    passes = 1 if bf16_math else TC_PASSES.get(kind, 1)
    if kind in ("fwd", "dx", "dwmo"):
        products = (2 if kind == "dwmo" else 1) * gemm
        sampling = 30 * taps if kind == "dwmo" else 8 * taps
        if kind == "fwd":
            nbytes = n * C * x_bytes + offset_mask + weight + Co * f32 + n * Co * f32
        elif kind == "dx":   # x is not read: dx does not depend on it
            nbytes = offset_mask + weight + n * Co * f32 + n * C * f32
        else:                # outputs dmask, doffset and dW
            nbytes = n * C * x_bytes + offset_mask + weight + n * Co * f32 + offset_mask + weight
        return sampling, nbytes, passes * products
    if bf16_math:
        raise ValueError(f"{kind} has no bf16 math")
    if kind == "fwd_bn_relu":
        return (8 * taps + 3 * n * Co,
                n * C * x_bytes + offset_mask + weight + 2 * Co * f32 + n * Co * f32,
                TC_PASSES[kind] * gemm)
    x_in, offset, mask = n * C * x_bytes, n * 18 * f32, n * 9 * f32
    if kind == "dma":
        return 0, x_in + n * C * f32, 0
    if kind in ("window", "aligned"):
        return (9 if kind == "window" else 5) * taps, x_in + offset + n * C * f32, 0
    if kind == "matmul":
        return taps, x_in + mask + weight + n * Co * f32, passes * gemm
    if kind == "nomap":
        return 4 * R * n * C, x_in + weight + n * Co * f32, passes * gemm
    if kind == "nobcast":
        return (4 * (2 * R + 1) * taps + 11 * (2 * R + 1) * 9 * n,
                x_in + offset + mask + weight + n * Co * f32, passes * gemm)
    raise ValueError(kind)


def bound_of(ops: float, nbytes: float, tc_ops: float = 0):
    """(bound_ms, bound_by): the largest of ``ops`` over the f32 peak,
    ``tc_ops`` over the bf16 tensor-core peak (the two units run side by
    side) and the bytes over the memory rate."""
    t_ops = max(ops / F32_PEAK_FLOPS, tc_ops / BF16_TC_PEAK_FLOPS)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_kernel(shapes=DCN_SHAPES, batch: int = BATCH) -> dict:
    """dcn_fwd against the plain op at ``shapes`` (the neck's by default),
    x in bf16 (the default impl, cast inside the kernel), and bit-equal to
    the kernel on x cast to bf16 first and on x handed over in bf16 (a bf16
    model's entry, also timed); the kernel is also timed with x in f32, the
    transfer of the pallas3, pallas2, pallas2p and pallas impls."""
    worst = 0.0
    ms_fwd = plain_fwd = f32_fwd = bf16x_fwd = 0.0
    ops = nbytes = tc = 0
    for i, ((H, W, C, Co), layers) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(i)
        x = torch.randn(batch, H, W, C, device="cuda", generator=g)
        # fractional, and beyond +-R often enough to exercise the clamp
        off = torch.randn(batch, H, W, 18, device="cuda", generator=g) * 1.5
        mask = torch.rand(batch, H, W, 9, device="cuda", generator=g)
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

        # a bf16 model's x arrives in bf16 and enters the kernel as it is
        x16 = x.to(torch.bfloat16)

        def kernel_bf16x():
            return dcn_cuda.dcn_forward(x16, *args[1:], **kw)

        wide_before = dcn_cuda.dcn_forward.wide_launches
        y = kernel()
        tile = dcn_cuda.fwd_tile_n(Co)
        moved = dcn_cuda.dcn_forward.wide_launches - wide_before
        if moved != int(tile == 256):
            raise AssertionError(f"dcn_fwd {(batch, H, W, C, Co)}: wide_launches moved by "
                                 f"{moved} at tile {tile}")
        err = (y - plain()).abs().max().item()
        if not (err <= KERNEL_TOL and torch.isfinite(y).all()):
            raise AssertionError(f"dcn_fwd {(batch, H, W, C, Co)}: max abs err {err} > {KERNEL_TOL}")
        # the folded cast: f32 x rounded in the kernel as it is loaded, against
        # the kernel on x cast to bf16 first; bit-equal
        with torch.no_grad():
            cast_first = dcn_cuda._fwd_kernel(x.to(torch.bfloat16), off, mask, w, b, R)
        if not (torch.equal(y, cast_first) and torch.equal(y, kernel_bf16x())):
            raise AssertionError(f"dcn_fwd {(batch, H, W, C, Co)}: the folded cast differs from "
                                 f"cast-then-kernel by {(y - cast_first).abs().max().item()}")
        del cast_first
        # plain, kernel, kernel, plain: drift in clocks hits both sides alike
        p1, k1, f1, b1 = (time_ms(plain, 5), time_ms(kernel, 20), time_ms(kernel_f32, 20),
                          time_ms(kernel_bf16x, 20))
        b2, f2, k2, p2 = (time_ms(kernel_bf16x, 20), time_ms(kernel_f32, 20), time_ms(kernel, 20),
                          time_ms(plain, 5))
        k_ms, p_ms, f_ms, b_ms = (k1 + k2) / 2, (p1 + p2) / 2, (f1 + f2) / 2, (b1 + b2) / 2
        worst = max(worst, err)
        ms_fwd += layers * k_ms
        plain_fwd += layers * p_ms
        f32_fwd += layers * f_ms
        bf16x_fwd += layers * b_ms
        work = dcn_work("fwd", H, W, C, Co, x.element_size(), batch=batch)
        ops, nbytes, tc = ops + layers * work[0], nbytes + layers * work[1], tc + layers * work[2]
        phase("kernel", f"dcn_fwd B,H,W,C,Co={(batch, H, W, C, Co)} layers={layers} tile={tile} "
                        f"max_abs_err={err:.3e} (tol {KERNEL_TOL}) kernel_ms={k_ms:.4f} "
                        f"plain_ms={p_ms:.4f} kernel_f32x_ms={f_ms:.4f} "
                        f"kernel_bf16x_ms={b_ms:.4f}")
        del x, x16, off, mask, w, b, args, y
    torch.cuda.empty_cache()
    bound_ms, bound_by = bound_of(ops, nbytes, tc)
    phase("kernel", f"per forward ({sum(n for _, n in shapes)} layers, batch {batch}): "
                    f"kernel_ms={ms_fwd:.4f} plain_ms={plain_fwd:.4f} "
                    f"kernel_f32x_ms={f32_fwd:.4f} kernel_bf16x_ms={bf16x_fwd:.4f} (x in bf16, "
                    f"as a bf16 model gives it) "
                    f"bound_ms={bound_ms:.4f} ({bound_by}: {tc / 1e9:.1f} GFLOP on the tensor "
                    f"cores ({TC_PASSES['fwd']} bf16 passes), {ops / 1e9:.1f} f32 GFLOP, "
                    f"{nbytes / 1e9:.3f} GB); every layer's folded cast bit-equal to "
                    f"cast-then-kernel; wide_launches per forward {wide_per_forward(shapes)}")
    return {"max_abs_err": worst, "ms": ms_fwd, "plain_ms": plain_fwd, "bound_ms": bound_ms,
            "bound_by": bound_by}


def bev_rig():
    """(lidar2img (6, 4, 4), the pillar points' image locations (6, 40000,
    4, 2), which cells each camera sees (6, 40000)) of the benchmark's
    nuScenes rig (mfbench/traffic/camera_scenes.json) at 1600x900, padded to
    928, by the plain BEVFormer's published point sampling."""
    from mfbench.reference_bevformer import bevformer as plain
    from mfbench.sources.camera_scene_batches import lidar2img
    from mfbench.spec import data_file, load_json

    traffic = load_json(data_file("traffic", "camera_scenes"))
    l2i = torch.from_numpy(lidar2img(traffic["cameras"], traffic["mount"],
                                     traffic["mount_down"], BEV_H, BEV_W))
    ref_3d = plain.reference_points_3d(200, 200, plain.PC_RANGE[5] - plain.PC_RANGE[2])
    cam, mask = plain.point_sampling(ref_3d, l2i, (-(-BEV_H // 32) * 32, BEV_W))
    return l2i, cam[:, 0].contiguous(), mask[:, 0].any(-1)


def check_msda() -> dict:
    """msda_fwd against the plain op (ops/msda.py::msda_plain, f32) at
    BEVFormer-base's three families, bf16 values and f32 locations and
    weights as the model gives them: the relative error against MSDA_TOL,
    two launches bit-equal, ms of each, and the work_bevformer bound of
    each call and of the 18 calls of a forward."""
    from mfbench import work_bevformer as W
    from monoflex_tpu_torch.ops import msda

    _, ref_cam, visible = bev_rig()
    levels = W.level_shapes(BEV_H, BEV_W)
    calls = W.msda_calls(levels, BEV_CAMS, int(visible.sum()))
    families = {"tsa": calls[0], "sca": calls[1], "decoder": calls[-1]}
    per_forward = {k: sum(c == v for c in calls) for k, v in families.items()}
    worst = worst_rel = ms = plain_ms = bound = 0.0
    for i, (name, call) in enumerate(families.items()):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        G, Q, L, P, A = (call[k] for k in ("groups", "queries", "levels", "points", "anchors"))
        shapes = levels if name == "sca" else [(200, 200)]
        value = torch.randn(G, call["keys"], 8, 32, device="cuda", generator=g).to(torch.bfloat16)
        if name == "sca":
            ref = ref_cam.to("cuda")
        elif name == "tsa":
            ys, xs = torch.meshgrid((torch.arange(200, device="cuda") + 0.5) / 200,
                                    (torch.arange(200, device="cuda") + 0.5) / 200, indexing="ij")
            ref = torch.stack([xs.flatten(), ys.flatten()], -1)[None, :, None].repeat(G, 1, 1, 1)
            ref[0] += 0.01      # the first queue's shifted points
        else:
            ref = torch.rand(G, Q, A, 2, device="cuda", generator=g)
        # a few cells or pixels about the reference points, as the seeded weights spread them
        offsets = torch.randn(Q, 8, call["offset_groups"], L, P, 2, device="cuda",
                              generator=g) * 2
        weights = torch.rand(Q, 8, call["weight_groups"], L, P, device="cuda", generator=g)
        weights = weights / weights.sum((-1, -2), keepdim=True)
        mask = visible.to("cuda") if call["masked"] else None
        scale = 0.5 if name == "tsa" else 1.0
        args = (value, shapes, ref, offsets, weights, mask, scale)
        before = msda.msda_forward.launches
        got = msda.msda_forward(*args)
        torch.cuda.synchronize()
        if msda.msda_forward.launches != before + 1 or got.dtype != torch.bfloat16:
            raise AssertionError(f"msda_fwd {name}: launches moved by "
                                 f"{msda.msda_forward.launches - before}, dtype {got.dtype}")
        want = msda.msda_plain(*args, out_dtype=torch.float32)
        rms = float(want.square().mean().sqrt())
        err = float((got.float() - want).abs().max())
        rel = err / rms / max(1.0, float(want.abs().max()) / rms)
        if not (rel < MSDA_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"msda_fwd {name}: error {rel:.3e} of the RMS > {MSDA_TOL}")
        if not torch.equal(got, msda.msda_forward(*args)):
            raise AssertionError(f"msda_fwd {name}: two launches differ")
        k_ms, p_ms = time_ms(lambda: msda.msda_forward(*args), 20), time_ms(
            lambda: msda.msda_plain(*args), 3)
        b_ms = W.bound_s(W.msda_work(call)) * 1e3
        n = per_forward[name]
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        ms, plain_ms, bound = ms + n * k_ms, plain_ms + n * p_ms, bound + n * b_ms
        phase("kernel", f"msda_fwd {name} groups={G} keys={call['keys']} queries={Q} levels={L} "
                        f"points={P} pairs={call['pairs']} calls={n}: max_abs_err={err:.3e} "
                        f"({rel:.3e} of the RMS, tol {MSDA_TOL:.3e}) kernel_ms={k_ms:.4f} "
                        f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} "
                        f"({100 * b_ms / k_ms:.2f}% of the roofline)")
        del value, ref, offsets, weights, mask, args, got, want
    torch.cuda.empty_cache()
    phase("kernel", f"msda_fwd per forward ({sum(per_forward.values())} calls): kernel_ms={ms:.4f} "
                    f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} "
                    f"({100 * bound / ms:.2f}% of the roofline; bytes at the memory rate)")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes"}


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
        dcn_cuda.dcn_forward.launches = dcn_cuda.dcn_forward.wide_launches = 0
        passes = 3
        t0 = time.perf_counter()
        for _ in range(passes):
            out, rows, valid = infer(model)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dcn_cuda.dcn_forward.launches
        wide = dcn_cuda.dcn_forward.wide_launches

        if launches != 16 * passes:
            raise AssertionError(f"{launches} dcn_fwd launches in {passes} forwards, want {16 * passes}")
        if wide != wide_per_forward(DCN_SHAPES) * passes:
            raise AssertionError(f"{wide} dcn_fwd wide_launches in {passes} forwards, want "
                                 f"{wide_per_forward(DCN_SHAPES) * passes}")
        if tuple(rows.shape) != (BATCH, 50, 14) or not torch.isfinite(rows).all():
            raise AssertionError(f"rows {tuple(rows.shape)} finite={bool(torch.isfinite(rows).all())}")
        for key, t in [("cls", out["cls"])] + [(f"reg{i}", r) for i, r in enumerate(out["reg"])]:
            if not torch.isfinite(t).all():
                raise AssertionError(f"head map {key} is not finite")
        phase("slice", f"{passes} forward+decode passes at batch {BATCH}, 384x1280: "
                       f"{BATCH * passes / elapsed:.2f} img/s on {torch.cuda.get_device_name(0)}; "
                       f"dcn_fwd launches={launches} wide_launches={wide}; "
                       f"rows {tuple(rows.shape)} finite, "
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
    work = {"dx": [0, 0, 0], "dwmo": [0, 0, 0]}
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
        # deterministic: a second launch on the same inputs is bit-equal
        again = kernel_dwmo()
        if not all(torch.equal(a, b) for a, b in zip((dmask, dw, doff), again)):
            raise AssertionError(f"dcn_bwd_dwmo {(BATCH, H, W, C, Co)}: two launches differ")
        if not torch.equal(dx, kernel_dx()):
            raise AssertionError(f"dcn_bwd_dx {(BATCH, H, W, C, Co)}: two launches differ")
        del again
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
            work[name] = [t + layers * v for t, v in
                          zip(work[name], dcn_work(name, H, W, C, Co, x.element_size()))]
        phase("bwd", f"B,H,W,C,Co={(BATCH, H, W, C, Co)} layers={layers} "
                     + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items())
                     + f" (tol {BWD_RTOL} of max |ref|) "
                     + " ".join(f"{k}_ms={v:.4f}" for k, v in times.items())
                     + "; dx and dwmo each twice bit-equal")
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
                           f"{work[k][0] / 1e9:.1f} f32 GFLOP, {work[k][2] / 1e9:.1f} GFLOP on "
                           f"the tensor cores, {work[k][1] / 1e9:.3f} GB)"
                           for k, v in out.items()))
    check_backward_clamp()
    return out


def check_backward_clamp() -> None:
    """dcn_bwd_dx at R = CLAMP_PER_STAGE[0] at ida_0's shapes, where its
    layout stages g in 16-channel slices and the floors per tap: against the
    plain backward within BWD_RTOL, twice bit-equal; ms per layer, kernel and
    plain backward in turns, beside the same kernel at the neck's R."""
    r8 = CLAMP_PER_STAGE[0]
    for i, (H, W, C, Co) in enumerate(CLAMP_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(700 + i)
        x = torch.randn(BATCH, H, W, C, device="cuda", generator=g).to(torch.bfloat16)
        # 6 sigma: sources up to 8 pixels away, and some clipped
        off = torch.randn(BATCH, H, W, 18, device="cuda", generator=g) * 6
        mask = torch.rand(BATCH, H, W, 9, device="cuda", generator=g)
        w = torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5
        gy = torch.randn(BATCH, H, W, Co, device="cuda", generator=g)

        def kernel(r=r8):
            return dcn_cuda.dcn_bwd_dx(x, off, mask, w, gy, max_offset=r)

        def plain():
            return modulated_deform_conv_backward(x.float(), off, mask, w, gy, max_offset=r8,
                                                  wrt=("x",))[0]

        dx, ref = kernel(), plain()
        if not torch.equal(dx, kernel()):
            raise AssertionError(f"dcn_bwd_dx {(BATCH, H, W, C, Co)} R={r8}: two launches differ")
        err = (dx - ref).abs().max().item()
        bound = BWD_RTOL * ref.abs().max().item()
        if not (err <= bound and torch.isfinite(dx).all()):
            raise AssertionError(f"dx {(BATCH, H, W, C, Co)} R={r8}: max abs err {err} > {bound} "
                                 f"({BWD_RTOL} of max |ref|)")
        del dx, ref
        p1, k1, n1, n2, k2, p2 = (time_ms(plain, 3), time_ms(kernel, 10),
                                  time_ms(lambda: kernel(R), 10), time_ms(lambda: kernel(R), 10),
                                  time_ms(kernel, 10), time_ms(plain, 3))
        phase("bwd", f"per-stage clamp: dcn_bwd_dx B,H,W,C,Co={(BATCH, H, W, C, Co)} R={r8} "
                     f"dx_err={err:.3e} (tol {BWD_RTOL} of max |ref|) dx_ms={(k1 + k2) / 2:.4f} "
                     f"plain_dx_ms={(p1 + p2) / 2:.4f} (the kernel at R={R}: "
                     f"{(n1 + n2) / 2:.4f}); twice bit-equal")
        del x, off, mask, w, gy
        torch.cuda.empty_cache()
    check_backward_wide()


def check_backward_wide() -> None:
    """dcn_bwd_dx at R = WIDE_R, past its halo's reach, where the kernel's
    wide path (u = g W^T, then a gather of u without a halo) runs: against
    the plain backward within BWD_RTOL, twice bit-equal; ms per layer,
    kernel and plain backward in turns, beside the layer's bound."""
    H, W, C, Co = CLAMP_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(800)
    x = torch.randn(BATCH, H, W, C, device="cuda", generator=g).to(torch.bfloat16)
    # 12 sigma: sources up to 16 pixels away, and some clipped
    off = torch.randn(BATCH, H, W, 18, device="cuda", generator=g) * 12
    mask = torch.rand(BATCH, H, W, 9, device="cuda", generator=g)
    w = torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5
    gy = torch.randn(BATCH, H, W, Co, device="cuda", generator=g)
    shape = (BATCH, H, W, C, Co)

    def kernel():
        return dcn_cuda.dcn_bwd_dx(x, off, mask, w, gy, max_offset=WIDE_R)

    def plain():
        return modulated_deform_conv_backward(x.float(), off, mask, w, gy, max_offset=WIDE_R,
                                              wrt=("x",))[0]

    dx, ref = kernel(), plain()
    if not torch.equal(dx, kernel()):
        raise AssertionError(f"dcn_bwd_dx {shape} R={WIDE_R}: two launches differ")
    err = (dx - ref).abs().max().item()
    bound = BWD_RTOL * ref.abs().max().item()
    if not (err <= bound and torch.isfinite(dx).all()):
        raise AssertionError(f"dx {shape} R={WIDE_R}: max abs err {err} > {bound} "
                             f"({BWD_RTOL} of max |ref|)")
    del dx, ref
    p1, k1, k2, p2 = time_ms(plain, 3), time_ms(kernel, 5), time_ms(kernel, 5), time_ms(plain, 3)
    bound_ms, bound_by = bound_of(*dcn_work("dx", H, W, C, Co, x.element_size()))
    phase("bwd", f"wide path: dcn_bwd_dx B,H,W,C,Co={shape} R={WIDE_R} dx_err={err:.3e} "
                 f"(tol {BWD_RTOL} of max |ref|) dx_ms={(k1 + k2) / 2:.4f} "
                 f"plain_dx_ms={(p1 + p2) / 2:.4f} bound_ms={bound_ms:.4f} ({bound_by}); "
                 f"twice bit-equal")
    del x, off, mask, w, gy
    torch.cuda.empty_cache()


def compare_steps(state: dict, cfg, batch: dict, label: str = "") -> dict:
    """One kernel step and one plain-op step from the same saved state, x in
    f32 (``tools/step_drift.py::step_drift``): the total loss and every
    parameter's gradient against the tolerances."""
    d = step_drift(state, cfg, batch)
    phase("train", f"{label}kernel step vs plain-op step: total {d['total_kernel']:.6f} vs "
                   f"{d['total_plain']:.6f} (rel {d['loss_rel_err']:.3e}, tol {STEP_LOSS_RTOL}); "
                   f"worst gradient rel L2 {d['grad_rel_l2']:.3e} ({d['worst_param']}; tol "
                   f"{STEP_GRAD_REL_L2}) over {d['params']} parameters; biases into train-mode "
                   f"BN {d['zero_grad_max']:.3e} (tol {ZERO_GRAD_RTOL} x {d['grad_max']:.3e})")
    if not (d["loss_rel_err"] <= STEP_LOSS_RTOL and d["grad_rel_l2"] <= STEP_GRAD_REL_L2
            and d["zero_grad_max"] <= ZERO_GRAD_RTOL * d["grad_max"]):
        raise AssertionError("the kernel step and the plain-op step disagree")
    return {"loss_rel_err": d["loss_rel_err"], "grad_rel_l2": d["grad_rel_l2"]}


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
    # the documented per-stage clamp: the kernel step takes dcn_bwd_dx at R = 8
    # in ida_0, with no ValueError and no plain op in its place
    clamp = cfg.clone()
    clamp.TPU.DCN_MAX_OFFSET_PER_STAGE = CLAMP_PER_STAGE
    for f in counters:
        f.launches = 0
    compare_steps(state_dict, clamp, batch, label=f"per-stage clamp {CLAMP_PER_STAGE}: ")
    clamp_launches = {f.__name__: f.launches for f in counters}
    if any(n != 16 for n in clamp_launches.values()):
        raise AssertionError(f"per-stage clamp step launches {clamp_launches}, want 16 each")
    phase("train", "per-stage clamp step launches "
                   + " ".join(f"{k}={v}" for k, v in clamp_launches.items()))
    return {"launches": launches}


def check_epilogue() -> dict:
    """dcn_fwd with the fused BN+ReLU epilogue against its plain version at
    the neck's shapes, batch 8, R=2, x in bf16 (as the served model feeds
    it), BN from seeded statistics with the conv bias folded into the shift;
    ms per call of the fused kernel, the plain fused op, and the unfused
    path it replaces (dcn_fwd, then BatchNorm and ReLU), timed in turns."""
    worst = worst_unfused = 0.0
    total = {"ms": 0.0, "plain_ms": 0.0, "unfused_ms": 0.0}
    ops = nbytes = tc = 0
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
        ops, nbytes, tc = ops + layers * work[0], nbytes + layers * work[1], tc + layers * work[2]
        phase("eval", f"dcn_fwd_bn_relu B,H,W,C,Co={(BATCH, H, W, C, Co)} layers={layers} "
                      f"max_abs_err={err:.3e} (vs dcn_fwd+BN+ReLU {err_unfused:.3e}; tol "
                      f"{KERNEL_TOL}) " + " ".join(f"{k}={v:.4f}" for k, v in times.items()))
        del x, off, mask, w, b, y
    torch.cuda.empty_cache()
    bound_ms, bound_by = bound_of(ops, nbytes, tc)
    phase("eval", "dcn_fwd_bn_relu per forward (16 layers): "
                  + " ".join(f"{k}={v:.4f}" for k, v in total.items())
                  + f" bound_ms={bound_ms:.4f} ({bound_by}: {tc / 1e9:.1f} GFLOP on the tensor "
                    f"cores, {ops / 1e9:.1f} f32 GFLOP, {nbytes / 1e9:.3f} GB)")
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
                f.launches = f.wide_launches = 0
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
            wide = sum(f.wide_launches for f in counters)
            if wide != wide_per_forward(DCN_SHAPES) * forwards:
                raise AssertionError(f"({label}) {wide} wide_launches in {forwards} forwards")
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
                          + f" (wide_launches={wide // forwards}); 16 txts, "
                          f"{len(AP_KEYS)} finite R40 APs "
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


def run_bevformer() -> dict:
    """BEVFormer-base's evaluation path (bf16, seeded weights, the
    benchmark's rig): make_eval_step's graphed forward and NMS-free decode
    over BEV_CALLS, scene starts and calls with the history; each forward
    launches msda_fwd 18 times (the counter zeroed first) and never the
    plain op; one capture, every later call a replay; the history counters;
    finite (1, 300, 11) rows; a replayed call with the history against the
    eager forward from the same history; ms a call and the peak memory."""
    from monoflex_tpu_torch.decode.postprocessor import build_postprocessor
    from monoflex_tpu_torch.ops import msda
    from monoflex_tpu_torch.utils import trace

    cfg = get_cfg_defaults()
    cfg.merge_from_list(["MODEL.META_ARCHITECTURE", "BEVFormer", "MODEL.BACKBONE.CONV_BODY",
                         "R-101", "INPUT.PIXEL_MEAN", "[0.406, 0.456, 0.485]",
                         "INPUT.PIXEL_STD", f"[{1 / 255!r}, {1 / 255!r}, {1 / 255!r}]",
                         "INPUT.TO_BGR", "True", "DATALOADER.SIZE_DIVISIBILITY", "32",
                         "TPU.COMPUTE_DTYPE", "bfloat16"])
    model = build_model(cfg, device="cuda", seed=5)
    l2i = bev_rig()[0].to("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    images = [torch.randint(0, 256, (BEV_CAMS, BEV_H, BEV_W, 3), device="cuda", generator=g,
                            dtype=torch.uint8) for _ in range(2)]

    def batch(i: int, start: bool) -> dict:
        bus = torch.zeros(18, device="cuda")
        if not start:      # 4 m along the heading and a 1.5 degree turn since the last sample
            bus[0], bus[1], bus[17] = 4.0, 0.3, 1.5
        bus[16] = 0.2 * i
        return {"image": images[i % 2], "lidar2img": l2i, "can_bus": bus,
                "scene_start": torch.tensor([start], device="cuda")}

    step = make_eval_step(model, build_postprocessor(cfg))
    plain_calls = [0]
    plain = msda.msda_plain

    def counted(*a, **k):
        plain_calls[0] += 1
        return plain(*a, **k)

    msda.msda_plain = counted
    msda.msda_forward.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trace.drain()
    trace.on()
    times, checked = [], None
    try:
        for i, start in enumerate(BEV_CALLS):
            b = batch(i, start)
            prev = model.prev_bev.clone()
            t0 = time.perf_counter()
            rows, valid, extras = step(b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if tuple(rows.shape) != (1, 300, 11) or not torch.isfinite(rows).all():
                raise AssertionError(f"bevformer call {i}: rows {tuple(rows.shape)}, finite "
                                     f"{bool(torch.isfinite(rows).all())}")
            if checked is None and i >= 2 and not start:
                after = model.prev_bev.clone()
                model.prev_bev.copy_(prev)
                with torch.inference_mode():
                    want = model(b["image"], l2i, b["can_bus"], b["scene_start"])
                checked = max(float((extras[k].float() - want[k].float()).abs().max()
                                    / want[k].float().abs().max()) for k in ("bev", "cls", "boxes"))
                model.prev_bev.copy_(after)
                msda.msda_forward.launches -= MSDA_PER_FORWARD
    finally:
        trace.off()
        msda.msda_plain = plain
    counters = trace.drain().counters
    n = len(BEV_CALLS)
    launches = msda.msda_forward.launches
    starts = sum(BEV_CALLS)
    want_counts = {"eval_step.graph_captures": 1, "eval_step.graph_replays": n - 1,
                   "bev.scene_starts": starts, "bev.history_used": n - starts}
    got_counts = {k: counters.get(k, 0) for k in want_counts}
    if launches != MSDA_PER_FORWARD * n or plain_calls[0] or got_counts != want_counts:
        raise AssertionError(f"bevformer: msda_fwd launches {launches} (want "
                             f"{MSDA_PER_FORWARD * n}), plain op calls {plain_calls[0]}, "
                             f"counters {got_counts} (want {want_counts})")
    if checked is None or not checked < 1e-3:
        raise AssertionError(f"bevformer: a replay against the eager forward {checked}")
    replayed = times[2:]
    ms = 1e3 * sum(replayed) / len(replayed)
    phase("bevformer", f"{n} calls of one sample (6x1600x900, bf16), scene starts at "
                       f"{[i for i, s in enumerate(BEV_CALLS) if s]}: msda_fwd launches "
                       f"{launches} ({launches // n} a forward), plain op calls 0; counters "
                       + " ".join(f"{k}={v}" for k, v in got_counts.items())
                       + f"; a replay with history against the eager forward {checked:.3e} "
                       f"of max |eager|; replayed call {ms:.2f} ms ({6e3 / ms:.2f} img/s, "
                       f"decode and copies included); first (eager) {1e3 * times[0]:.1f} ms, "
                       f"capture {1e3 * times[1]:.1f} ms; peak memory "
                       f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del model, step, images
    torch.cuda.empty_cache()
    return {"launches": launches}


def check_ablate() -> dict:
    """Each dcn_ablate variant against its plain version at kernel_diag's
    default shapes, batch 8, R=2: max error, ms per call of kernel and plain
    version in turns (and of the one PyTorch call of the same function:
    x.clone() for dma, F.conv2d with nomap's combined kernel, TF32 off),
    summed over the two shapes; dcn_fwd (f32 x, no bias) timed beside them,
    the split of its time.  The kernels, dcn_fwd and the library calls are
    timed on the device (``graph_ms``: at the small shape an eager launch of
    dma or x.clone() times the host) over ``rotating`` copies of the inputs
    (twice the L2), so that each call reads them from device memory; a time
    below its bound (x.clone() held to dma's) fails the phase."""
    library = ("dma", "nomap")
    out = {v: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "work": [0, 0, 0],
               "library_ms": 0.0 if v in library else None} for v in ABLATE_VARIANTS}
    for i, (H, W, C, Co) in enumerate(DIAG_SHAPES):
        x, off, mask, w = diag_inputs(300 + i, H, W, C, Co)
        sets = rotating(x, off, mask, w)
        with torch.no_grad():
            full = sum(graph_ms(lambda *a: dcn_cuda.dcn_forward(*a, None, max_offset=R), sets, 20)
                       for _ in range(2)) / 2
        bounds = {v: bound_of(*dcn_work(v, H, W, C, Co, x.element_size()))[0]
                  for v in ("fwd", *ABLATE_VARIANTS)}
        split = {}
        for v in ABLATE_VARIANTS:
            def kernel(*a):
                return dcn_ablate(*a, variant=v, max_offset=R)

            def plain():
                return dcn_ablate_reference(x, off, mask, w, variant=v, max_offset=R)

            y, ref = kernel(x, off, mask, w), plain()
            err = (y - ref).abs().max().item()
            tol = 0.0 if v == "dma" else ABLATE_RTOL * ref.abs().max().item()
            if not (err <= tol and torch.isfinite(y).all()):
                raise AssertionError(f"dcn_ablate[{v}] {(BATCH, H, W, C, Co)}: max abs err {err} "
                                     f"> {tol}")
            if v == "dma":
                if not torch.equal(x.clone(), y):
                    raise AssertionError("dcn_ablate[dma] differs from x.clone()")

                def lib(xs, *_):
                    return xs.clone()
            elif v == "nomap":
                K = nomap_conv_weight(w, R)

                def lib(xs, *_):
                    return F.conv2d(xs.permute(0, 3, 1, 2), K, padding=R + 1)

                lib_err = (lib(x).permute(0, 2, 3, 1) - ref).abs().max().item()
                if not lib_err <= ABLATE_RTOL * ref.abs().max().item():
                    raise AssertionError(f"F.conv2d for nomap {(BATCH, H, W, C, Co)}: max abs "
                                         f"err {lib_err}")
            if v in library:
                p1, k1, l1, l2, k2, p2 = (time_ms(plain, 3), graph_ms(kernel, sets, 20),
                                          graph_ms(lib, sets, 10), graph_ms(lib, sets, 10),
                                          graph_ms(kernel, sets, 20), time_ms(plain, 3))
                out[v]["library_ms"] += (l1 + l2) / 2
                if v == "dma" and min(l1, l2) < bounds["dma"]:
                    raise AssertionError(f"x.clone() {(BATCH, H, W, C)}: {min(l1, l2):.4f} ms, "
                                         f"below its bound {bounds['dma']:.4f}")
            else:
                p1, k1, k2, p2 = (time_ms(plain, 3), graph_ms(kernel, sets, 20),
                                  graph_ms(kernel, sets, 20), time_ms(plain, 3))
            if min(k1, k2) < bounds[v]:
                raise AssertionError(f"dcn_ablate[{v}] {(BATCH, H, W, C, Co)}: {min(k1, k2):.4f} "
                                     f"ms, below its bound {bounds[v]:.4f}")
            rec = out[v]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["ms"] += (k1 + k2) / 2
            rec["plain_ms"] += (p1 + p2) / 2
            rec["work"] = [t + u for t, u in zip(rec["work"],
                                                 dcn_work(v, H, W, C, Co, x.element_size()))]
            split[v] = (k1 + k2) / 2
            del y, ref
        phase("diag", f"dcn_fwd split B,H,W,C,Co={(BATCH, H, W, C, Co)} R={R}, device ms (share of "
                      f"dcn_fwd, bound ms) over {len(sets)} rotating input sets: dcn_fwd(f32 x)_ms="
                      f"{full:.4f} (1, {bounds['fwd']:.4f}) "
                      + " ".join(f"{v}_ms={ms:.4f} ({ms / full:.2f}, {bounds[v]:.4f})"
                                 for v, ms in split.items()))
        del x, off, mask, w, sets
        torch.cuda.empty_cache()
    for v, rec in out.items():
        rec["bound_ms"], rec["bound_by"] = bound_of(*rec.pop("work"))
        phase("diag", f"dcn_ablate[{v}] over {len(DIAG_SHAPES)} shapes: max_abs_err="
                      f"{rec['max_abs_err']:.3e} (tol {0 if v == 'dma' else ABLATE_RTOL} of max "
                      f"|ref|) ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} bound_ms="
                      f"{rec['bound_ms']:.4f} ({rec['bound_by']})"
                      + (f" library_ms({'x.clone' if v == 'dma' else 'F.conv2d'})="
                         f"{rec['library_ms']:.4f}" if v in library else ""))
    return out


def check_relayout() -> dict:
    """The relayout kernel against its plain version (pad + permute +
    contiguous) and the one PyTorch call, F.pad of the permuted view, at
    transpose_ablate's default shape, R=2: exact; ms of each in turns."""
    B, H, W, C = RELAYOUT_SHAPE
    x = torch.randn(B, H, W, C, device="cuda", generator=torch.Generator(device="cuda").manual_seed(400))
    P, _, wp2f, Cs = relayout_dims(H, W, C, R)

    def kernel():
        return relayout(x, R)

    def plain():
        return relayout_reference(x, R)

    def library():
        return F.pad(x.permute(0, 1, 3, 2), (P, wp2f - W - P, 0, Cs - C))

    y = kernel()
    if not (torch.equal(y, plain()) and torch.equal(y, library())):
        raise AssertionError("relayout differs from its plain version or F.pad(x.permute(...))")
    p1, k1, l1, l2, k2, p2 = (time_ms(plain, 20), time_ms(kernel, 20), time_ms(library, 20),
                              time_ms(library, 20), time_ms(kernel, 20), time_ms(plain, 20))
    bound_ms, bound_by = bound_of(0, x.numel() * 4 + y.numel() * 4)
    rec = {"max_abs_err": 0.0, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "library_ms": (l1 + l2) / 2, "bound_ms": bound_ms, "bound_by": bound_by}
    phase("diag", f"relayout {tuple(x.shape)} -> {tuple(y.shape)}: exact vs plain and library; "
                  + " ".join(f"{k}={v:.4f}" for k, v in rec.items() if k.endswith("ms")))
    return rec


def bf16_math_errors(x, off, mask, w, b, gy, max_offset: int):
    """The bf16-math kernels' outputs against the plain op and its backward
    in bf16 math, and the f32-math kernels' against the same: per output
    (fwd, dx, dmask, doffset, dW), (max abs error of the bf16 kernel, its
    share of max |ref|, the f32 kernel's share).  The bf16-math dx must be
    bit-equal over two launches."""
    bf16, f32 = torch.bfloat16, torch.float32
    ref = dict(zip(("dx", "doffset", "dmask", "dW"), modulated_deform_conv_backward(
        x, off, mask, w, gy, max_offset=max_offset, compute_dtype=bf16)))
    ref["fwd"] = modulated_deform_conv(x, off, mask, w, b, max_offset=max_offset,
                                       compute_dtype=bf16)
    got = {}
    with torch.no_grad():
        for dt in (bf16, f32):
            kw = dict(max_offset=max_offset, compute_dtype=dt)
            dmask, dw, doff = dcn_cuda.dcn_bwd_dwmo(x, off, mask, w, gy, **kw)
            got[dt] = {"fwd": dcn_cuda.dcn_forward(x, off, mask, w, b, **kw),
                       "dx": dcn_cuda.dcn_bwd_dx(x, off, mask, w, gy, **kw),
                       "dmask": dmask, "doffset": doff, "dW": dw}
        again = dcn_cuda.dcn_bwd_dx(x, off, mask, w, gy, max_offset=max_offset,
                                    compute_dtype=bf16)
    if not torch.equal(got[bf16]["dx"], again):
        raise AssertionError(f"bf16 math dx {tuple(x.shape)} R={max_offset}: two launches differ")
    out = {}
    for key in ("fwd", "dx", "dmask", "doffset", "dW"):
        if not torch.isfinite(got[bf16][key]).all():
            raise AssertionError(f"bf16 math {key}: non-finite values")
        scale = ref[key].abs().max().item()
        err = (got[bf16][key] - ref[key]).abs().max().item()
        gap = (got[f32][key] - ref[key]).abs().max().item()
        out[key] = (err, err / scale, gap / scale)
    return out


def check_bf16_math() -> dict:
    """dcn_fwd, dcn_bwd_dx and dcn_bwd_dwmo in bf16 window math against the
    plain op and its backward in the same mode at the neck's shapes, batch
    8, at R=2 and at R=1 (kernel_bench's bf16r1): each output within
    BF16_RTOL of the largest |ref|, and the same kernels in f32 math
    further than that from it, so the tolerance tells the modes apart; ms
    per forward or step (16 layers) at R=2, kernel and plain version in
    turns."""
    bf16 = torch.bfloat16
    worst = {"fwd": 0.0, "dx": 0.0, "dwmo": 0.0}
    total = {k: {"ms": 0.0, "plain_ms": 0.0, "work": [0, 0, 0]} for k in worst}
    failed = []
    for i, ((H, W, C, Co), layers) in enumerate(DCN_SHAPES):
        if layers == 0:
            continue
        x, off, mask, w = diag_inputs(500 + i, H, W, C, Co)
        g = torch.Generator(device="cuda").manual_seed(600 + i)
        b = torch.randn(Co, device="cuda", generator=g) * 0.1
        gy = torch.randn(BATCH, H, W, Co, device="cuda", generator=g)
        for r in (R, 1):
            errs = bf16_math_errors(x, off, mask, w, b, gy, r)
            for key, (err, rel, gap) in errs.items():
                if not rel <= BF16_RTOL < gap:
                    failed.append(f"{key} {(BATCH, H, W, C, Co)} R={r}: bf16 kernel {rel:.3e}, "
                                  f"f32 kernel {gap:.3e} of max |ref|")
                if r == R:
                    k = key if key in worst else "dwmo"
                    worst[k] = max(worst[k], err)
            phase("diag", f"bf16 math B,H,W,C,Co={(BATCH, H, W, C, Co)} R={r} share of max |ref| "
                          f"(tol {BF16_RTOL}), bf16-math kernel / f32-math kernel vs bf16 plain: "
                          + " ".join(f"{k}={rel:.3e}/{gap:.3e}"
                                     for k, (_, rel, gap) in errs.items())
                          + "; dx twice bit-equal")
        kw = dict(max_offset=R, compute_dtype=bf16)
        runs = {
            "fwd": (lambda: dcn_cuda.dcn_forward(x, off, mask, w, b, **kw),
                    lambda: modulated_deform_conv(x, off, mask, w, b, **kw)),
            "dx": (lambda: dcn_cuda.dcn_bwd_dx(x, off, mask, w, gy, **kw),
                   lambda: modulated_deform_conv_backward(x, off, mask, w, gy, wrt=("x",), **kw)),
            "dwmo": (lambda: dcn_cuda.dcn_bwd_dwmo(x, off, mask, w, gy, **kw),
                     lambda: modulated_deform_conv_backward(
                         x, off, mask, w, gy, wrt=("offset", "mask", "weight"), **kw)),
        }
        times = {}
        with torch.no_grad():
            for key, (kern, plain) in runs.items():
                n_k, n_p = (20, 5) if key == "fwd" else (10, 3)
                p1, k1, k2, p2 = (time_ms(plain, n_p), time_ms(kern, n_k), time_ms(kern, n_k),
                                  time_ms(plain, n_p))
                times[key] = (k1 + k2) / 2
                total[key]["ms"] += layers * (k1 + k2) / 2
                total[key]["plain_ms"] += layers * (p1 + p2) / 2
                work = dcn_work(key, H, W, C, Co, x.element_size(), bf16_math=True)
                total[key]["work"] = [t + layers * v for t, v in zip(total[key]["work"], work)]
        phase("diag", f"bf16 math B,H,W,C,Co={(BATCH, H, W, C, Co)} layers={layers} R={R} "
                      + " ".join(f"{k}_ms={v:.4f}" for k, v in times.items()))
        del x, off, mask, w, b, gy
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("bf16 math outside its tolerance, or f32 math inside it: "
                             + "; ".join(failed))
    out = {}
    for key, rec in total.items():
        bound_ms, bound_by = bound_of(*rec["work"])
        out[key] = {"max_abs_err": worst[key], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    phase("diag", "bf16 math per forward/step (16 layers): "
                  + " ".join(f"{k}_ms={v['ms']:.4f} {k}_plain_ms={v['plain_ms']:.4f} "
                             f"{k}_bound_ms={v['bound_ms']:.4f}" for k, v in out.items()))
    return out


def run_module(module: str, args, env: dict, log: str):
    """``python -m <module> *args`` in its own process, which writes its
    kernels' launch counts to ``log`` at its end: (the process, the counts)."""
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env={**env, LAUNCH_LOG_ENV: log}, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    with open(log) as f:
        return proc, json.load(f)


def run_tool(name: str, args, tmp: str, label: str = "diag", env=None):
    """``python -m monoflex_tpu_torch.tools.<name> *args`` in its own
    process: its stdout lines and the launch counts it wrote at its end."""
    t0 = time.perf_counter()
    proc, launches = run_module(f"monoflex_tpu_torch.tools.{name}", args,
                                dict(os.environ) if env is None else env,
                                os.path.join(tmp, f"{name}.launches.json"))
    lines = proc.stdout.splitlines()
    # tools/trace_time.py takes a trace again when the profiler dropped records
    retraced = proc.stderr.count("lost device records")
    phase(label, f"{name} {' '.join(args)}: exit 0 in {time.perf_counter() - t0:.2f} s, "
                 f"{len(lines)} lines, {retraced} profiler traces taken again")
    return lines, launches


def finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def run_tools() -> dict:
    """The four tools through their entry points; returns the launches of
    every kernel summed over the four processes."""
    total = {}
    with tempfile.TemporaryDirectory(prefix="monoflex_diag_") as tmp:
        def run(name, args, check):
            lines, launches = run_tool(name, [*args, "--iters", str(TOOL_ITERS)], tmp)
            check(lines)
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n

        def check_records(keys):
            def check(lines):
                recs = [json.loads(line) for line in lines]
                for rec in recs:
                    bad = [k for k in rec if k.endswith("error")]
                    if bad or not all(finite(rec.get(k)) for k in keys):
                        raise AssertionError(f"record {rec}")
                    phase("diag", json.dumps(rec))
                return recs
            return check

        run("kernel_bench", ["--variants", "f32r2,bf16r1", "--shapes", "all", "--bwd",
                             "--out", os.path.join(tmp, "kbench.jsonl")],
            check_records(("fwd_ms", "bwd_ms")))
        run("kernel_diag", ["--out", os.path.join(tmp, "kdiag.jsonl")], check_records(("ms",)))

        def check_fwd_ablate(lines):
            seen = {}
            for line in lines:
                m = re.fullmatch(r"(\S+)\s+compile\s+(\S+)s\s+device\s+(\S+) ms/call"
                                 r"\s+relerr (\S+)", line.strip())
                if m is None:
                    raise AssertionError(f"fwd_ablate line {line!r}")
                v, ms, rel = m.group(1), float(m.group(3)), float(m.group(4))
                tol = (None if v in ("nomap", "nobcast") else
                       PARITY_BF16_TOL if v.endswith("bf16") else PARITY_F32_TOL)
                if not finite(ms) or (tol is not None and not rel <= tol):
                    raise AssertionError(f"fwd_ablate {v}: ms {ms}, relerr {rel} (tol {tol})")
                seen[v] = line.strip()
                phase("diag", line.strip())
            if sorted(seen) != sorted(FWD_ABLATE_VARIANTS):
                raise AssertionError(f"fwd_ablate ran {sorted(seen)}")

        run("fwd_ablate", ["--parity", "--variants", ",".join(FWD_ABLATE_VARIANTS)],
            check_fwd_ablate)

        def check_transpose(lines):
            seen = []
            for line in lines:
                m = re.match(r"(\S+)\s+ms/call=\s*(\S+)\s+maxerr=(\S+)", line)
                if m is None or not finite(float(m.group(2))) or float(m.group(3)) != 0.0:
                    raise AssertionError(f"transpose_ablate line {line!r}")
                seen.append(m.group(1))
                phase("diag", line)
            if seen != list(TRANSPOSE_VARIANTS):
                raise AssertionError(f"transpose_ablate ran {seen}")

        run("transpose_ablate", ["--variants", ",".join(TRANSPOSE_VARIANTS)], check_transpose)
    return total


def run_diag() -> dict:
    """The diag phase; returns the kernels' records keyed by their name in
    the kernels line, each with its launches in the tools' run."""
    ablate = check_ablate()
    relay = check_relayout()
    bf16 = check_bf16_math()
    launches = run_tools()
    recs = {"dcn_fwd[bf16 math]": bf16["fwd"], "dcn_bwd_dx[bf16 math]": bf16["dx"],
            "dcn_bwd_dwmo[bf16 math]": bf16["dwmo"], "relayout": relay,
            **{f"dcn_ablate[{v}]": rec for v, rec in ablate.items()}}
    missing = [k for k in recs if not launches.get(k)]
    if missing:
        raise AssertionError(f"the tools' run launched no {missing}")
    phase("diag", "launches in the tools' run: "
                  + " ".join(f"{k}={launches[k]}" for k in recs))
    return {k: {**rec, "launches": launches[k]} for k, rec in recs.items()}


def trainer_opts(max_iter: int, batch: int = BATCH):
    """KEY VALUE opts of the trainer phase's CLI runs on its trainval tree."""
    return ["DATASETS.TRAIN_SPLIT", "trainval", "DATASETS.TEST_SPLIT", "trainval",
            "SOLVER.IMS_PER_BATCH", str(batch), "SOLVER.EVAL_AND_SAVE_EPOCH", "False",
            "SOLVER.MAX_ITERATION", str(max_iter),
            "SOLVER.SAVE_CHECKPOINT_INTERVAL", str(TRAINER_SAVE),
            "SOLVER.EVAL_INTERVAL", str(TRAINER_ITERS), "TEST.IMS_PER_BATCH", str(batch),
            "SEED", "0"]


def run_cli(args, env: dict, tmp: str, label: str):
    """``python -m monoflex_tpu_torch.cli *args`` in its own process: its
    stdout and the launch counts it wrote at its end."""
    t0 = time.perf_counter()
    proc, launches = run_module("monoflex_tpu_torch.cli", args, env,
                                os.path.join(tmp, f"{label}.launches.json"))
    phase("trainer", f"cli ({label}): exit 0 in {time.perf_counter() - t0:.2f} s")
    return proc.stdout, launches


def loop_meters(log: str, max_iter: int) -> dict:
    """The time and data meters (s) of the loop's log points at iterations
    max_iter / 2 and max_iter, from its log lines (median and global
    average of the values at the log points): the time and the data time
    per iteration of each 10-iteration window;
    and the second window's time without the checkpoint saved at its start."""
    points = {}
    for m in re.finditer(r"iter (\d+)/(\d+) .*?time: (\S+) \((\S+)\)  data: (\S+) \((\S+)\)",
                         log):
        if int(m.group(2)) == max_iter:
            points[int(m.group(1))] = [float(m.group(k)) for k in range(3, 7)]
    half = max_iter // 2
    if sorted(points) != [half, max_iter]:
        raise AssertionError(f"log points {sorted(points)}, want {[half, max_iter]}")
    # two values at the second point: its global average is their mean
    first_time, first_data = points[half][0], points[half][2]
    m = re.search(rf"saved model_checkpoint_{half} in (\S+) s", log)
    if m is None:
        raise AssertionError(f"no save at iteration {half} in the log")
    second = 2 * points[max_iter][1] - first_time
    return {"time_first": first_time, "time_second": second,
            "time_second_no_save": second - float(m.group(1)) / (max_iter - half),
            "save_s": float(m.group(1)),
            "data_first": first_data, "data_second": 2 * points[max_iter][3] - first_data}


def profile_window(log: str):
    """The profiled window's wall and device busy ms and idle share, from
    the loop's log line; None where the profiler kept no device record."""
    if re.search(r"profiler trace of \d+ steps written to \S+; wall \S+ ms, the trace holds "
                 r"no device records", log):
        return None
    m = re.search(r"profiler trace of (\d+) steps written to \S+; wall (\S+) ms, device busy "
                  r"(\S+) ms, idle share (\S+)", log)
    if m is None:
        raise AssertionError("no profile line in the log")
    return {"steps": int(m.group(1)), "wall_ms": float(m.group(2)),
            "busy_ms": float(m.group(3)), "idle_share": float(m.group(4))}


def check_trainer_launches(launches: dict, iters: int, forwards: int, label: str) -> None:
    """16 launches of each DCN kernel per train iteration, and of dcn_fwd
    (fused or not) per eval forward."""
    fwd = launches["dcn_fwd"] + launches["dcn_fwd_bn_relu"]
    got = (fwd, launches["dcn_bwd_dx"], launches["dcn_bwd_dwmo"])
    want = (16 * (iters + forwards), 16 * iters, 16 * iters)
    if got != want:
        raise AssertionError(f"({label}) launches fwd/dx/dwmo {got}, want {want} for {iters} "
                             f"iterations and {forwards} eval forwards")


def last_terms(out_dir: str, names) -> dict:
    """The last logged train record, checked: every loss term finite, no
    skip at the log point."""
    with open(os.path.join(out_dir, "tensorboard", "scalars.jsonl")) as f:
        rec = [json.loads(line) for line in f if '"train/' in line][-1]
    bad = [k for k in names if not finite(rec.get(f"train/{k}"))]
    if len(names) != 11 or bad or rec["train/skipped"] != 0.0:
        raise AssertionError(f"step {rec['step']}: non-finite terms {bad}, skipped "
                             f"{rec.get('train/skipped')}")
    return rec


def run_trainer(card: str) -> dict:
    """The trainer phase; returns the kernels' launches over its three runs."""
    forwards = math.ceil(EVAL_FRAMES / BATCH)
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex_ema.yaml"))
    names = cfg.MODEL.HEAD.LOSS_NAMES
    with tempfile.TemporaryDirectory(prefix="monoflex_trainer_") as tmp:
        t0 = time.perf_counter()
        make_synthetic_kitti(os.path.join(tmp, "kitti", "training"),
                             n_random_frames=EVAL_FRAMES - 3, render=True)
        out = os.path.join(tmp, "run")
        env = {**os.environ, "MONOFLEX_DATA_DIR": tmp}
        env.pop("MONOFLEX_PLATFORM", None)
        base = ["--config", os.path.join(ROOT, "runs", "monoflex_ema.yaml"), "--output", out]
        phase("trainer", f"tree of {EVAL_FRAMES} frames (1242x375, trainval) in "
                         f"{time.perf_counter() - t0:.2f} s")

        log, train = run_cli([*base, "--profile", str(TRAINER_PROFILE),
                              *trainer_opts(TRAINER_ITERS)], env, tmp, "train")
        check_trainer_launches(train, TRAINER_ITERS, forwards, "train")
        rec = last_terms(out, names)
        ckpt = os.path.join(out, "ckpt")
        names_on_disk = sorted(os.listdir(ckpt))
        want = sorted(["last_checkpoint", f"model_checkpoint_{TRAINER_SAVE}", "model_final",
                       "model_final_ema", "model_moderate_best_soft"])
        if names_on_disk != want:
            raise AssertionError(f"checkpoints {names_on_disk}, want {want}")
        meters = loop_meters(log, TRAINER_ITERS)
        prof = profile_window(log)
        phase("trainer", f"train {TRAINER_ITERS} iterations at batch {BATCH}, 384x1280 on "
                         f"{card}: iterations {TRAINER_ITERS // 2 + 1}-{TRAINER_ITERS} (after the "
                         f"checkpoint at {TRAINER_SAVE}) {BATCH / meters['time_second']:.2f} "
                         f"img/s, time {meters['time_second'] * 1e3:.1f} ms/iteration; "
                         f"without the save ({meters['save_s']:.3f} s) "
                         f"{BATCH / meters['time_second_no_save']:.2f} img/s, "
                         f"{meters['time_second_no_save'] * 1e3:.1f} ms/iteration "
                         f"(1-{TRAINER_ITERS // 2}, with the first and the profile: "
                         f"{meters['time_first'] * 1e3:.1f}), data "
                         f"{meters['data_second'] * 1e3:.1f} ms at iteration {TRAINER_ITERS} "
                         f"({meters['data_first'] * 1e3:.1f} at {TRAINER_ITERS // 2}); "
                         f"launches " + " ".join(f"{k}={train[k]}" for k in
                                                  ("dcn_fwd", "dcn_bwd_dx", "dcn_bwd_dwmo"))
                         + f"; 11 terms finite at {rec['step']}, total_loss "
                         f"{rec['train/total_loss']:.4f}; checkpoints {', '.join(names_on_disk)}")
        phase("trainer", f"profile of iterations 2-{TRAINER_PROFILE + 1} on {card}: " + (
            "not measured (the profiler kept no device record)" if prof is None else
            f"wall {prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms, idle share "
            f"{prof['idle_share']:.4f} ({prof['wall_ms'] / prof['steps']:.2f} ms/iteration)"))

        # the eval and the resumed run are checked, not timed: without
        # cuDNN's autotune a process reaches its first step in seconds, not
        # in the half minute the autotune of every convolution takes
        untuned = ["CUDNN_BENCHMARK", "False"]
        log, evaluation = run_cli([*base, "--eval", "--ckpt",
                                   os.path.join(ckpt, "model_final_ema"),
                                   *trainer_opts(TRAINER_ITERS), *untuned], env, tmp, "eval")
        check_trainer_launches(evaluation, 0, forwards, "eval")
        txts = [f for f in os.listdir(os.path.join(out, "inference", "data"))
                if f.endswith(".txt")]
        if len(txts) != EVAL_FRAMES or "metric = R40" not in log:
            raise AssertionError(f"--eval wrote {len(txts)} txts, want {EVAL_FRAMES}, and AP")

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            address = f"127.0.0.1:{sock.getsockname()[1]}"
        log, resume = run_cli([*base, "--num_processes", "1", "--process_id", "0",
                               "--coordinator_address", address,
                               *trainer_opts(TRAINER_RESUME), *untuned], env, tmp, "resume")
        check_trainer_launches(resume, TRAINER_RESUME - TRAINER_ITERS, 0, "resume")
        for line in (f"resumed from iteration {TRAINER_ITERS}",
                     f"optimizer count {TRAINER_ITERS} after the restore",
                     "process group nccl: rank 0 of 1",
                     "training through DistributedDataParallel"):
            if line not in log:
                raise AssertionError(f"the resumed run's log lacks {line!r}")
        rec = last_terms(out, names)
        final = torch.load(os.path.join(ckpt, "model_final"), map_location="cpu",
                           weights_only=True)
        if (rec["step"], final["optimizer"]["count"], final["state"]["step"]) != (
                TRAINER_RESUME,) * 3:
            raise AssertionError(f"resumed run ends at step {rec['step']}, optimizer count "
                                 f"{final['optimizer']['count']}: a step was skipped")
        phase("trainer", f"--eval of model_final_ema: {len(txts)} txts, R40 tables; resumed "
                         f"from {TRAINER_ITERS} with count {TRAINER_ITERS} over NCCL/DDP at "
                         f"world size 1 to {TRAINER_RESUME}: 11 terms finite, optimizer "
                         f"count {TRAINER_RESUME}; launches per iteration "
                         + " ".join(f"{k}={resume[k] // (TRAINER_RESUME - TRAINER_ITERS)}"
                                    for k in ("dcn_fwd", "dcn_bwd_dx", "dcn_bwd_dwmo")))
    return {k: train[k] + evaluation[k] + resume[k] for k in train}


# the configs phase.  bf16 model, kernels vs the plain op, eval mode: both
# round the same activations to bf16, after f32 sums of the DCN in another
# order (1e-6 relative apart), so now and then a BN output rounds to the
# neighbouring bf16 value (2^-8 relative) and the next layers carry it; the
# CPU tests find the port's bf16 model 1.9e-3 from the JAX one on these maps
# (which differ from it the same way), against 2e-4 in f32
BF16_HEADS_TOL = 2e-2
# the bf16 step, kernels vs plain op, from one state.  In train mode the
# batch statistics make a bf16 step chaotic (a last-bit change of one
# activation reaches every gradient: the CPU tests find the JAX bf16 step's
# gradients at a median 100% from its own f32 step's), so the step is
# compared with the statistics fixed (BN on its running statistics, eval
# mode, the same losses and backward).  The state it is read at comes from
# 6 train-mode steps, which are not bit-reproducible on the card, so the
# reading moves with it.  The limits stand between the sound readings and
# those of another function (this check and tools/bf16_step_spread.py on
# an H100, 9 sound readings over 4 runs and 4 seeds: gradient median 1.6e-3 to
# 9.6e-3, worst 2.3e-2 to 0.121; the plain step against itself reads a
# worst of 2.0e-2 on the stem's kernel; the clamp one pixel narrower reads
# a median of 6.6e-2 or more and a worst of 0.67 or more): the median to
# 2e-2 (2.1x the largest sound reading, 3.3x under the nearest wrong one),
# the worst to 0.25 (2.1x and 2.7x), the 11 terms' sum to 1e-3 relative
# (sound readings up to 7.8e-6)
BF16_STEP_LOSS_RTOL = 1e-3
BF16_STEP_GRAD_REL_L2 = 0.25
BF16_STEP_GRAD_MEDIAN = 2e-2
BF16_PASSES = 10
BF16_STEPS = 5
# gather vs pallas3 (f32 x both): with every offset inside R the same
# function, summed in another order through 16 DCN layers (the neck output to
# 1e-4 of its largest element, the head maps to HEADS_TOL); with offsets up
# to 4.5 pixels (R = 2) the clamp moves most samples, and the neck outputs
# must part by more than 10% of the largest element
GATHER_NECK_RTOL = 1e-4
GATHER_UNCLAMPED_RDIFF = 0.1
# the mixed neck ("gather", "pallas3b", "pallas3b", "pallas3b"): ida_0's two
# DCNs on the unbounded plain op, the other 14 through dcn_fwd
MIXED_IMPLS = ("gather", "pallas3b", "pallas3b", "pallas3b")
IDA0_DCNS = 2
# the other configurations: a forward each, without cuDNN's autotune (a
# new set of convolution shapes each, checked and timed, not tuned)
OTHER_CONFIGS = (
    ("dla34_nodcn", "monoflex.yaml", ("MODEL.BACKBONE.CONV_BODY", "dla34_nodcn"), 0),
    ("GN heads", "monoflex.yaml", ("MODEL.HEAD.USE_NORMALIZATION", "GN"), 16),
    ("dlav0", "monoflex.yaml", ("MODEL.BACKBONE.CONV_BODY", "dlav0"), 0),
    ("dlav0_dla169", "monoflex.yaml", ("MODEL.BACKBONE.CONV_BODY", "dlav0_dla169"), 0),
    ("shift under bf16", "monoflex_bf16.yaml", ("TPU.DCN_FORCE_IMPL", "shift"), 0))


def config_of(yaml: str, *overrides) -> object:
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", yaml))
    cfg.merge_from_list(list(overrides))
    return cfg


def check_outputs(label: str, out: dict, images: torch.Tensor, rows=None) -> None:
    """Finite maps: a (B, 3, H/4, W/4) heatmap and 9 regression maps for
    NHWC ``images``; finite (B, 50, 14) rows."""
    maps = [out["cls"], *out["reg"]]
    B, H, W, _ = images.shape
    if tuple(out["cls"].shape) != (B, 3, H // 4, W // 4) or len(maps) != 10:
        raise AssertionError(f"{label}: cls {tuple(out['cls'].shape)}, {len(maps)} maps")
    if not all(torch.isfinite(t).all() for t in maps):
        raise AssertionError(f"{label}: a head map is not finite")
    if rows is not None and (tuple(rows.shape) != (B, 50, 14) or not torch.isfinite(rows).all()):
        raise AssertionError(f"{label}: rows {tuple(rows.shape)} not finite")


def passes_per_s(fn, passes: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        fn()
    torch.cuda.synchronize()
    return BATCH * passes / (time.perf_counter() - t0)


def check_bf16(card: str) -> dict:
    """runs/monoflex_bf16.yaml (pallas3b): forward + decode on the kernels
    against the plain op, img/s beside the f32 model's in this call, a
    device split of one pass of each, BF16_STEPS training steps and the
    kernel step against the plain step with the statistics fixed."""
    cfg16, cfg32 = config_of("monoflex_bf16.yaml"), config_of("monoflex.yaml")
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_inference_batch(BATCH).items()}
    post = PostProcessor(cfg16)
    m32 = build_model(cfg32, device="cuda", seed=0)
    perturb_offset_convs(m32, seed=1)
    models = {}
    for label, cfg, kernel in (("bf16", cfg16, True), ("bf16 plain", cfg16, False),
                               ("f32", cfg32, True)):
        models[label] = build_model(cfg, device="cuda", use_dcn_kernel=kernel)
        models[label].load_state_dict(m32.state_dict())
    del m32

    def infer(label):
        def run():
            out = models[label](batch["image"], batch["edge_indices"], batch["edge_len"])
            return out, post(out, batch)
        return run

    with torch.inference_mode():
        out, (rows, valid, _) = infer("bf16")()
        check_outputs("bf16", out, batch["image"], rows)
        err = max_head_err(out, infer("bf16 plain")()[0])
        for f in (dcn_cuda.dcn_forward, dcn_cuda.dcn_bwd_dx, dcn_cuda.dcn_bwd_dwmo):
            f.launches = 0
        rate16 = passes_per_s(infer("bf16"), BF16_PASSES)
        launches = dcn_cuda.dcn_forward.launches
        rate32 = passes_per_s(infer("f32"), BF16_PASSES)
        splits = {label: split(infer(label), 3) for label in ("bf16", "f32")}
    if launches != 16 * (BF16_PASSES + 1):
        raise AssertionError(f"bf16: {launches} dcn_fwd launches in {BF16_PASSES + 1} forwards")
    phase("configs", f"bf16 (runs/monoflex_bf16.yaml, pallas3b) forward+decode at batch "
                     f"{BATCH}, 384x1280: {rate16:.2f} img/s over {BF16_PASSES} passes against "
                     f"{rate32:.2f} for the f32 model (runs/monoflex.yaml) in this call, on "
                     f"{card}; dcn_fwd launches={launches} ({BF16_PASSES} passes + warm-up); "
                     f"rows finite, {int(valid.sum())} above threshold; head maps kernel vs "
                     f"plain op max abs err {err:.3e} (tol {BF16_HEADS_TOL})")
    for label, rec in splits.items():
        top = ", ".join(f"{k} {v:.2f}" for k, v in list(rec["device_ms"].items())[:6])
        phase("configs", f"{label} pass, device split (torch.profiler, 3 passes): wall "
                         f"{rec['wall_ms']:.2f} ms, busy {rec['busy_ms']:.2f} ms, idle share "
                         f"{rec['idle_share']:.4f}, peak {rec['peak_gb']:.2f} GB; device ms: {top}")
    if not err <= BF16_HEADS_TOL:
        raise AssertionError(f"bf16 head maps differ by {err} > {BF16_HEADS_TOL}")
    models.clear()
    torch.cuda.empty_cache()

    # training: the train phase's milder offset convs, AdamW, BF16_STEPS steps
    model = build_model(cfg16, device="cuda", seed=0)
    perturb_offset_convs(model, seed=1, weight_scale=0.2)
    tbatch = {k: torch.from_numpy(v).cuda() for k, v in make_train_batch(BATCH).items()}
    optimizer, _, _ = build_optimizer(cfg16, model)
    train_step = make_train_step(model, LossComputer(cfg16), optimizer)
    state, metrics = train_step(TrainState(), tbatch)              # warm-up
    torch.cuda.synchronize()
    counters = (dcn_cuda.dcn_forward, dcn_cuda.dcn_bwd_dx, dcn_cuda.dcn_bwd_dwmo)
    for f in counters:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(BF16_STEPS):
        state, metrics = train_step(state, tbatch)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    step_launches = {f.__name__: f.launches for f in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(n != 16 * BF16_STEPS for n in step_launches.values()):
        raise AssertionError(f"bf16 steps launched {step_launches}, want {16 * BF16_STEPS} each")
    terms = list(cfg16.MODEL.HEAD.LOSS_NAMES)
    values = {k: float(metrics[k]) for k in terms + ["total_loss"]}
    if (len(terms) != 11 or not all(math.isfinite(v) for v in values.values())
            or metrics["skipped"] != 0.0 or state.skips != 0):
        raise AssertionError(f"bf16 steps: terms {values}, skipped {metrics['skipped']}")
    phase("configs", f"bf16 {BF16_STEPS} training steps at batch {BATCH}, 384x1280: "
                     f"{BATCH * BF16_STEPS / elapsed:.2f} img/s, peak {peak_gb:.2f} GB on {card}; "
                     "launches " + " ".join(f"{k}={v}" for k, v in step_launches.items())
                     + f"; total_loss {values['total_loss']:.4f}, 11 terms finite, skipped 0")
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    del model, optimizer, train_step
    torch.cuda.empty_cache()
    plain = fixed_stats_step(saved, cfg16, tbatch, False)
    got = step_distances(fixed_stats_step(saved, cfg16, tbatch, True), plain)
    floor = step_distances(fixed_stats_step(saved, cfg16, tbatch, False), plain)
    phase("configs", f"bf16 kernel step vs plain-op step, statistics fixed (eval-mode BN; the "
                     f"train-mode bf16 step is chaotic): total rel {got['loss_rel_err']:.3e} "
                     f"(tol {BF16_STEP_LOSS_RTOL}); gradient rel L2 median "
                     f"{got['grad_median']:.3e} (tol {BF16_STEP_GRAD_MEDIAN}), worst "
                     f"{got['grad_worst']:.3e} ({got['worst_param']}; tol {BF16_STEP_GRAD_REL_L2}) "
                     f"over {got['params']} parameters; the plain-op step against itself: total "
                     f"rel {floor['loss_rel_err']:.3e}, gradient median {floor['grad_median']:.3e}, "
                     f"worst {floor['grad_worst']:.3e} ({floor['worst_param']})")
    if (not got["loss_rel_err"] <= BF16_STEP_LOSS_RTOL
            or not got["grad_median"] <= BF16_STEP_GRAD_MEDIAN
            or not got["grad_worst"] <= BF16_STEP_GRAD_REL_L2):
        raise AssertionError("the bf16 kernel step and plain-op step disagree")
    del plain, saved
    torch.cuda.empty_cache()
    return {"forward": launches, "steps": step_launches}


@torch.no_grad()
def fixed_offsets(model: torch.nn.Module, seed: int, reach: float = 1.5) -> None:
    """Every offset/mask conv with zero weights and seeded biases: each
    offset a fixed fractional value in (-reach, reach) (inside any R >= 2 at
    the default), and seeded mask logits."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, DCN):
            conv = m.conv_offset_mask
            conv.weight.zero_()
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=g))
            conv.bias[:18] = reach * torch.tanh(conv.bias[:18])


@torch.no_grad()
def ida0_offsets_at(model: torch.nn.Module, value: float) -> None:
    """ida_0's offset biases set to ``value`` pixels (unbounded-trained
    weights there)."""
    for m in model.backbone.dla_up.ida_0.modules():
        if isinstance(m, DCN):
            m.conv_offset_mask.bias[:18] = value


def check_gather() -> dict:
    """The unbounded "gather" impl (the port of the JAX package's XLA
    gather op: plain PyTorch, no kernel): equal to pallas3 with every offset
    inside R, not with offsets up to 4.5 pixels; a mixed neck launches
    dcn_fwd on its kernel stages only; the forwards timed."""
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_inference_batch(BATCH).items()}
    args = (batch["image"], batch["edge_indices"], batch["edge_len"])
    cfg = config_of("monoflex.yaml")
    base = build_model(cfg, device="cuda", seed=0)
    diffs, neck_diffs, shares = {}, {}, {}
    with torch.inference_mode():
        for label, reach in (("inside R", 1.5), ("beyond R", 4.5)):
            fixed_offsets(base, seed=1, reach=reach)
            maps, feats = {}, {}
            for impl in ("gather", "pallas3"):
                model = build_model(config_of("monoflex.yaml", "TPU.DCN_FORCE_IMPL", impl),
                                    device="cuda")
                model.load_state_dict(base.state_dict())
                stats, handles = offset_stats(model)
                handles.append(model.backbone.register_forward_hook(
                    lambda _m, _i, out, impl=impl: feats.__setitem__(impl, out)))
                maps[impl] = model(*args)
                for h in handles:
                    h.remove()
                check_outputs(f"{impl} ({label})", maps[impl], batch["image"])
                if impl == "gather":
                    shares[label] = sum(st[0] for st in stats) / len(stats)
                    gather_ms = time_ms(lambda: model(*args), 3)
                del model
            diffs[label] = max_head_err(maps["gather"], maps["pallas3"])
            neck_diffs[label] = ((feats["gather"] - feats["pallas3"]).abs().max()
                                 / feats["pallas3"].abs().max()).item()
        mixed = build_model(config_of("monoflex.yaml", "TPU.DCN_IMPL_PER_STAGE", MIXED_IMPLS),
                            device="cuda")
        mixed.load_state_dict(base.state_dict())
        mixed(*args)
        dcn_cuda.dcn_forward.launches = 0
        check_outputs("mixed", mixed(*args), batch["image"])
        mixed_launches = dcn_cuda.dcn_forward.launches
        mixed_ms = time_ms(lambda: mixed(*args), 3)
    del base, mixed
    torch.cuda.empty_cache()
    phase("configs", f"gather (the port of the JAX package's XLA gather DCN, plain PyTorch, no "
                     f"kernel) vs pallas3, every offset inside R ({shares['inside R']:.3f} "
                     f"beyond): neck output {neck_diffs['inside R']:.3e} of its max (tol "
                     f"{GATHER_NECK_RTOL}), head maps {diffs['inside R']:.3e} (tol {HEADS_TOL}); "
                     f"{shares['beyond R']:.3f} of offsets beyond R: neck output "
                     f"{neck_diffs['beyond R']:.3e} of its max (must exceed "
                     f"{GATHER_UNCLAMPED_RDIFF}), head maps {diffs['beyond R']:.3e}; forward "
                     f"{gather_ms:.2f} ms at batch {BATCH}; mixed {list(MIXED_IMPLS)}: dcn_fwd "
                     f"launches={mixed_launches} (want {16 - IDA0_DCNS}), forward "
                     f"{mixed_ms:.2f} ms")
    if not (shares["inside R"] == 0 and neck_diffs["inside R"] <= GATHER_NECK_RTOL
            and diffs["inside R"] <= HEADS_TOL
            and neck_diffs["beyond R"] > GATHER_UNCLAMPED_RDIFF
            and mixed_launches == 16 - IDA0_DCNS):
        raise AssertionError("the gather impl does not behave as the unbounded DCN")
    return {"mixed": mixed_launches}


def check_guard() -> dict:
    """The offset guard under "auto" on weights whose ida_0 offsets pass its
    clamp: it reroutes ida_0 to gather, and the rerouted model runs."""
    cfg = config_of("monoflex.yaml", "TPU.DCN_OFFSET_GUARD", "auto")
    model = build_model(cfg, device="cuda", seed=0)
    fixed_offsets(model, seed=1)
    ida0_offsets_at(model, 7.0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_inference_batch(BATCH).items()}
    fired, suggestion, rows = dcn_offset_guard(cfg, model, batch,
                                               logger=logging.getLogger("chip_smoke"))
    if not (fired and suggestion == MIXED_IMPLS):
        raise AssertionError(f"guard: fired {fired}, suggestion {suggestion}, rows {rows}")
    reroute(cfg, model, suggestion)
    dcn_cuda.dcn_forward.launches = 0
    with torch.inference_mode():
        check_outputs("guard", model(batch["image"], batch["edge_indices"], batch["edge_len"]),
                      batch["image"])
    launches = dcn_cuda.dcn_forward.launches
    phase("configs", "guard (auto): rows " + "; ".join(
        f"stage {r['stage']} {r['impl']} R={r['R']:.0f} beyond {r['frac_clipped']:.3f}"
        for r in rows) + f"; suggestion {list(suggestion)}; the rerouted model runs, dcn_fwd "
        f"launches={launches}")
    if launches != 16 - IDA0_DCNS:
        raise AssertionError(f"guard: the rerouted model launched dcn_fwd {launches} times")
    del model
    torch.cuda.empty_cache()
    return {"guard": launches}


def check_other_configs() -> dict:
    """dla34_nodcn, GN heads, dlav0, dlav0_dla169 and the bf16 model on
    "shift" (the port of the JAX package's XLA clamped op): one checked
    forward each, then timed."""
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_inference_batch(BATCH).items()}
    args = (batch["image"], batch["edge_indices"], batch["edge_len"])
    launches = {}
    for label, yaml, override, want in OTHER_CONFIGS:
        cfg = config_of(yaml, *override, "CUDNN_BENCHMARK", False)
        model = build_model(cfg, device="cuda", seed=0)
        with torch.inference_mode():
            dcn_cuda.dcn_forward.launches = 0
            check_outputs(label, model(*args), batch["image"])
            launches[label] = dcn_cuda.dcn_forward.launches
            ms = time_ms(lambda: model(*args), 3)
        n_params = sum(p.numel() for p in model.parameters())
        phase("configs", f"{label}: forward at batch {BATCH}, 384x1280 finite, (8, 3, 96, 320) "
                         f"heatmap and 9 maps; {ms:.2f} ms ({BATCH / ms * 1e3:.2f} img/s, no "
                         f"autotune); {n_params / 1e6:.2f} M parameters; dcn_fwd launches="
                         f"{launches[label]}")
        if launches[label] != want:
            raise AssertionError(f"{label}: {launches[label]} dcn_fwd launches, want {want}")
        del model
        torch.cuda.empty_cache()
    return launches


def run_configs(card: str) -> dict:
    """The configs phase: every model configuration beyond the slice's."""
    t0 = time.perf_counter()
    out = {"bf16": check_bf16(card), **check_gather(), **check_guard(),
           **check_other_configs()}
    phase("configs", f"done in {time.perf_counter() - t0:.1f} s")
    return out


def perturbed_predictions(root: str, out: str, seed: int) -> None:
    """Detections from the tree's labels: each object perturbed (2D box 3 px,
    location 0.3 m, rotation 0.1 rad, as tests/test_torch_eval.py does) with
    a score, and up to 3 false positives an image."""
    import numpy as np

    classes = ("Car", "Pedestrian", "Cyclist")
    rng = np.random.RandomState(seed)
    os.makedirs(out, exist_ok=True)
    for i in (s.strip() for s in open(os.path.join(root, "ImageSets", "trainval.txt"))):
        with open(os.path.join(root, "label_2", f"{i}.txt")) as f:
            objs = [ln.split() for ln in f if ln.split()[0] in classes]
        with open(os.path.join(out, f"{i}.txt"), "w") as f:
            for ln in objs:
                vals = np.array(ln[3:], np.float64)
                vals[1:5] += rng.randn(4) * 3
                vals[8:11] += rng.randn(3) * 0.3
                vals[11] += rng.randn() * 0.1
                f.write(" ".join(ln[:3] + [f"{v:.2f}" for v in vals]
                                 + [f"{rng.uniform(0.3, 1):.4f}"]) + "\n")
            for _ in range(rng.randint(0, 4)):
                x, z, u = rng.uniform(-10, 10), rng.uniform(5, 50), rng.uniform(0, 1100)
                f.write(f"{classes[rng.randint(3)]} 0 0 0.1 {u:.2f} 150.00 {u + 60:.2f} 220.00 "
                        f"1.50 1.60 3.90 {x:.2f} 1.60 {z:.2f} 0.30 {rng.uniform(0, 0.6):.4f}\n")


def run_modules(card: str) -> dict:
    """The modules phase: the port's counterparts of the JAX package's last
    modules on the card (see the module docstring); returns its seconds."""
    import numpy as np

    from monoflex_tpu_torch import native
    from monoflex_tpu_torch.eval import evaluate_python
    from monoflex_tpu_torch.ops.psroi import deform_psroi_pooling
    from monoflex_tpu_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="monoflex_modules_") as tmp:
        # the C++ evaluator against the numpy one
        t0 = time.perf_counter()
        root = make_synthetic_kitti(os.path.join(tmp, "kitti", "training"),
                                    n_random_frames=MODULES_FRAMES - 3, render=True)
        pred = os.path.join(tmp, "pred")
        perturbed_predictions(root, pred, seed=5)
        args = (os.path.join(root, "label_2"), pred,
                os.path.join(root, "ImageSets", "trainval.txt"), ("Car", "Pedestrian", "Cyclist"))
        phase("modules", f"tree of {MODULES_FRAMES} rendered frames (1242x375) in "
                         f"{time.perf_counter() - t0:.2f} s")
        if native.evaluator_path() != "native":
            raise AssertionError("the KITTI evaluator did not load its C++ library")
        t0 = time.perf_counter()
        text, ap = evaluate_python(*args)
        t_native = time.perf_counter() - t0
        with native.numpy_only():
            t0 = time.perf_counter()
            np_text, np_ap = evaluate_python(*args)
            t_numpy = time.perf_counter() - t0
        if text != np_text or ap != np_ap or not 0 < ap["Car_3d_0.50/moderate"] < 100:
            raise AssertionError("the C++ evaluator's APs differ from the numpy one's")
        phase("modules", f"evaluator on {MODULES_FRAMES} frames of perturbed ground truth: "
                         f"native {t_native:.3f} s, numpy {t_numpy:.3f} s "
                         f"({t_numpy / t_native:.2f}x); {len(ap)} APs equal "
                         f"(Car_3d_0.50/moderate {ap['Car_3d_0.50/moderate']:.4f})")

        # inference(visualize=True) at full width
        cfg = config_of("monoflex.yaml", "DATASETS.TEST_SPLIT", "val", "TEST.IMS_PER_BATCH", str(BATCH),
                        "TEST.VISUALIZE_THRESHOLD", "0.0")
        t0 = time.perf_counter()
        model = build_model(cfg, device="cuda", seed=0)
        perturb_offset_convs(model, seed=1)
        dataset = KITTIDataset(cfg, root, is_train=False)
        out = inference(cfg, make_eval_step(model, PostProcessor(cfg)), dataset,
                        os.path.join(tmp, "vis_run"), visualize=True, device="cuda")
        pngs = sorted(os.listdir(os.path.join(tmp, "vis_run", "vis")))
        txts = os.listdir(os.path.join(tmp, "vis_run", "data"))
        if len(pngs) != min(8, len(dataset)) or len(txts) != len(dataset) or not finite(
                out["Car_3d_0.50/moderate"]):
            raise AssertionError(f"inference(visualize=True) wrote {pngs} for {len(dataset)} "
                                 f"images")
        phase("modules", f"inference(visualize=True) on {len(dataset)} images: {len(pngs)} PNGs "
                         f"in {time.perf_counter() - t0:.2f} s")

        # a reference-format checkpoint of a seeded full-width model
        ref_cfg = config_of("monoflex.yaml", "CUDNN_BENCHMARK", "False")
        source = build_model(ref_cfg, device="cuda", seed=5)
        perturb_offset_convs(source, seed=6)
        path = os.path.join(tmp, "reference.pth")
        torch.save({"model": {f"module.{k}": v for k, v in source.state_dict().items()},
                    "iteration": 0}, path)
        target = build_model(ref_cfg, device="cuda", seed=7)
        report = load_reference_checkpoint(target, path)
        batch = {k: torch.from_numpy(v).cuda() for k, v in make_inference_batch(BATCH).items()}
        maps = []
        for m in (source, target):
            maps.append(head_maps(m.eval(), batch))
        equal = all(torch.equal(a, b) for a, b in zip(
            [maps[0]["cls"], *maps[0]["reg"]], [maps[1]["cls"], *maps[1]["reg"]]))
        if not equal or report.missing or report.unexpected:
            raise AssertionError(f"reference checkpoint: {report}; head maps bit-equal {equal}")
        phase("modules", f"reference checkpoint ({os.path.getsize(path) / 1e6:.1f} MB): {report}; "
                         f"the batch-{BATCH} 384x1280 forward bit-equal to the source model's")
        del source, target, maps, model
        torch.cuda.empty_cache()

        # one full training step over NCCL at world size 1
        t0 = time.perf_counter()
        total = dryrun_multichip(1, device="cuda")
        phase("modules", f"dryrun_multichip(1) over NCCL: total_loss={total:.4f} in "
                         f"{time.perf_counter() - t0:.2f} s")

        # the convergence gate, short, then offset_stats and flops, as processes
        # (its own tree: the JAX tool's 1/4-scale rendered frames, at 96x320)
        conv_root = os.path.join(tmp, "conv_data")
        env = {**os.environ, "MONOFLEX_DATA_DIR": conv_root}
        env.pop("MONOFLEX_PLATFORM", None)
        conv_out = os.path.join(tmp, "conv_run")
        proc, _ = run_module("monoflex_tpu_torch.tools.convergence_run",
                             ["--root", conv_root, "--output", conv_out, "--frames",
                              str(MODULES_FRAMES), "--iters", str(MODULES_CONV_ITERS),
                              "--eval-interval", str(MODULES_CONV_ITERS)], env,
                             os.path.join(tmp, "conv.json"))
        table = [ln for ln in proc.stdout.splitlines() if ln.startswith("| ")]
        if len(table) != 2 or not table[1].startswith(f"| {MODULES_CONV_ITERS} |"):
            raise AssertionError(f"convergence_run printed no table:\n{proc.stdout[-2000:]}")
        windows = [float(m.group(1)) for m in re.finditer(r"iter \d+/\d+ .*?time: (\S+) ",
                                                          proc.stdout)]
        phase("modules", f"convergence_run --iters {MODULES_CONV_ITERS} on {card}: exit 0; "
                         f"the CLI at 96x320, batch 4: {windows[-1] * 1e3:.1f} ms an iteration "
                         f"(last window of 10); table {table[1]}")
        lines, _ = run_tool("offset_stats", ["--config", os.path.join(ROOT, "runs",
                                                                       "monoflex.yaml"),
                                             "--ckpt", os.path.join(conv_out, "ckpt",
                                                                    "model_final"),
                                             "--max_batches", "2", "INPUT.HEIGHT_TEST", "96",
                                             "INPUT.WIDTH_TEST", "320"], tmp, "modules", env)
        rows = [json.loads(ln) for ln in lines[1:]]
        if not lines[0].startswith("DCN |offset| stats over 2 batches") or len(rows) != 16:
            raise AssertionError(f"offset_stats printed {lines[:3]}")
        lines, _ = run_tool("flops", [], tmp, "modules", env)
        flops = json.loads("\n".join(lines))
        if not (finite(flops["fwd_gflops_per_img"]) and flops["train_gflops_per_img"]
                > 2 * flops["fwd_gflops_per_img"] > 0):
            raise AssertionError(f"flops printed {flops}")
        phase("modules", f"offset_stats: 16 layers, ida_0/proj_1 p99 {rows[1]['p99']}; flops: "
                         f"forward {flops['fwd_gflops_per_img']} GFLOP/img, train step "
                         f"{flops['train_gflops_per_img']} GFLOP/img")

    # PSROI pooling on the card against the CPU
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 24, 80, 3 * 49, generator=g)
    xy = torch.rand(6, 2, generator=g) * 60
    rois = torch.cat([torch.randint(0, 2, (6, 1), generator=g).float(), xy,
                      xy + 4 + torch.rand(6, 2, generator=g) * 40], dim=1)
    trans = torch.randn(6, 7, 7, 2, generator=g)
    kw = dict(spatial_scale=0.25, output_dim=3, group_size=7, pooled_size=7)
    cpu = deform_psroi_pooling(x, rois, trans, **kw)
    gpu = deform_psroi_pooling(x.cuda(), rois.cuda(), trans.cuda(), **kw).cpu()
    err = (gpu - cpu).abs().max().item()
    if not err <= PSROI_ATOL:
        raise AssertionError(f"psroi on the card vs the CPU: {err} > {PSROI_ATOL}")
    seconds = time.perf_counter() - t_phase
    phase("modules", f"psroi (6 rois, 7x7 parts) card vs CPU max abs err {err:.3e} (tol "
                     f"{PSROI_ATOL}); phase {seconds:.1f} s")
    return {"seconds": seconds}


def check_bench_line(line: str, metric: str, baseline: float) -> dict:
    """The JAX harness's last line: its four keys, a finite positive value,
    and vs_baseline = value / baseline as the JAX harness rounds them (both
    from the unrounded rate: value to 2 decimals, vs_baseline to 3)."""
    rec = json.loads(line)
    if (sorted(rec) != ["metric", "unit", "value", "vs_baseline"] or rec["metric"] != metric
            or rec["unit"] != "img/s" or not finite(rec["value"]) or not rec["value"] > 0
            or not abs(rec["vs_baseline"] - rec["value"] / baseline)
            <= 5e-4 + 5e-3 / baseline):
        raise AssertionError(f"{metric}: last line {line!r}")
    return rec


def run_bench(card: str) -> dict:
    """The bench phase (see the module docstring); returns its seconds."""
    from monoflex_tpu_torch import bench
    from monoflex_tpu_torch.entry import entry
    from monoflex_tpu_torch.tools import benchmark_train

    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "ABL_"))}
    env.pop("MONOFLEX_PLATFORM", None)
    runs = (("monoflex_tpu_torch.bench", "inference_images_per_sec_per_chip",
             bench.V100_BASELINE_IMG_PER_S, bench.DEFAULT_ITERS, False),
            ("monoflex_tpu_torch.tools.benchmark_train", "train_images_per_sec_per_chip",
             benchmark_train.TRAIN_BASELINE_IMG_S, benchmark_train.DEFAULT_ITERS, True))
    with tempfile.TemporaryDirectory(prefix="monoflex_bench_") as tmp:
        for module, metric, baseline, iters, train in runs:
            for dtype in ("float32", "bfloat16"):
                t0 = time.perf_counter()
                run_env = dict(env, BENCH_DTYPE=dtype) if dtype == "bfloat16" else env
                proc, launches = run_module(module, [], run_env,
                                            os.path.join(tmp, f"{metric}.{dtype}.json"))
                lines = proc.stdout.strip().splitlines()
                check_bench_line(lines[-1], metric, baseline)
                calls = bench.WARMUP_CALLS + iters
                got = (launches["dcn_fwd"], launches["dcn_bwd_dx"], launches["dcn_bwd_dwmo"])
                want = (16 * calls, 16 * calls if train else 0, 16 * calls if train else 0)
                if got != want:
                    raise AssertionError(f"{module} ({dtype}): launches fwd/dx/dwmo {got}, "
                                         f"want {want} for {calls} calls")
                for line in lines[:-1]:
                    phase("bench", f"{module} ({dtype}): {line}")
                phase("bench", f"{module} ({dtype}) on {card}: {lines[-1]}; dcn_fwd launches "
                               f"{got[0]} = 16 x ({bench.WARMUP_CALLS} + {iters}); exit 0 in "
                               f"{time.perf_counter() - t0:.2f} s")

        # entry() in this process
        t0 = time.perf_counter()
        fn, (model, batch) = entry()
        before = dcn_cuda.dcn_forward.launches
        rows, valid = fn(model, batch)
        torch.cuda.synchronize()
        if (tuple(rows.shape) != (BATCH, 50, 14) or not torch.isfinite(rows).all()
                or dcn_cuda.dcn_forward.launches - before != 16):
            raise AssertionError(f"entry(): rows {tuple(rows.shape)}, finite "
                                 f"{bool(torch.isfinite(rows).all())}, dcn_fwd launches "
                                 f"{dcn_cuda.dcn_forward.launches - before}")
        phase("bench", f"entry(): fn(model, batch) gives finite rows {tuple(rows.shape)}, "
                       f"{int(valid.sum())} valid, 16 dcn_fwd launches, in "
                       f"{time.perf_counter() - t0:.2f} s")
        del fn, model, batch, rows, valid
        torch.cuda.empty_cache()

        # the sweeps, as processes
        lines, _ = run_tool("kernel_sweep", ["--shapes", "0", "--variants", "f32r2",
                                             "--iters", str(SWEEP_ITERS)], tmp, "bench", env)
        recs = [json.loads(line) for line in lines]
        for rec in recs:
            if "error" in rec or not all(finite(rec.get(k)) and rec[k] > 0
                                         for k in ("ms_loop", "ms_device", "ms_percall")):
                raise AssertionError(f"kernel_sweep record {rec}")
            phase("bench", json.dumps(rec))
        if [r["kernel"] for r in recs] != ["fwd", "dx", "dwm", "doff"]:
            raise AssertionError(f"kernel_sweep timed {[r['kernel'] for r in recs]}")
        lines, _ = run_tool("bilinear_ablate", [], tmp, "bench",
                            dict(env, ABL_ITERS=str(SWEEP_ITERS)))
        recs = [json.loads(line) for line in lines]
        if len(recs) != 8 or not all(finite(r["ms_device"]) and r["ms_device"] > 0
                                     for r in recs):
            raise AssertionError(f"bilinear_ablate printed {lines}")
        for rec in recs:
            phase("bench", json.dumps(rec))
    seconds = time.perf_counter() - t_phase
    phase("bench", f"phase {seconds:.1f} s")
    return {"seconds": seconds}


@contextlib.contextmanager
def watchdog(name: str, seconds: float):
    """End the process with a message if the phase runs past ``seconds``: a
    kernel that waits forever (an mbarrier phase never completed) shows up
    as this line, not as a silent hang.  The kernels' own waits trap after
    about 20 s, which the phase then reports as a CUDA error."""
    def expire():
        print(f"[{name}] timed out after {seconds} s: a kernel or the host hangs", flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def build_report() -> dict:
    """Per kernel source: ptxas's registers, shared memory and spills of each
    __global__ function (nvcc -Xptxas -v), and the number of HGMMA (wgmma)
    instructions cuobjdump finds in its SASS."""
    out_dir = dcn_cuda.build_dir()
    report = {}
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for src in ("dcn_fwd", "dcn_bwd_dwmo", "dcn_bwd_dx", "dcn_ablate"):
        log = (out_dir / f"{src}.log").read_text()
        kernels = []
        name, spills = None, "spills ?"
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, spills = m.group(1), "spills ?"
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills = f"spills {m.group(1)}/{m.group(2)} B"
            m = re.search(r"Used (\d+) registers(?:, (\d+) bytes smem)?", line)
            if m and name and "_kernel" in name:
                kernels.append(f"{short_kernel_name(name)} {m.group(1)} regs, "
                               f"{m.group(2) or 0} B static smem, {spills}")
                name = None
        sass = subprocess.run([cuobjdump, "-sass", str(out_dir / f"{src}.so")],
                              capture_output=True, text=True, check=True).stdout
        hgmma = {}
        for block in sass.split("Function : ")[1:]:
            fn = short_kernel_name(block.split()[0])
            hgmma[fn] = hgmma.get(fn, 0) + block.count("HGMMA")
        if not any(hgmma.get(k, 0) for k in hgmma if "mo_kernel" in k or "fwd_kernel" in k
                   or "dw_kernel" in k or "dx_kernel" in k or "gemm_" in k):
            raise AssertionError(f"{src}: no HGMMA in its SASS")
        # every instantiation of the dx kernel and of the ablations' products
        # runs its product on wgmma
        bare = [k for k, v in hgmma.items() if ("dx_kernel" in k or "gemm_" in k) and not v]
        if bare:
            raise AssertionError(f"{src}: no HGMMA in {bare}")
        report[src] = ("; ".join(kernels) + " | HGMMA per instantiation: "
                       + ", ".join(f"{k}={v}" for k, v in sorted(hgmma.items())))
    return report


def short_kernel_name(mangled: str) -> str:
    """A mangled instantiation's kernel name and template arguments, e.g.
    dcn_fwd_kernel<f,1,0,128>."""
    m = re.search(r"\d+((?:dcn|fwd|dwmo|dx|gemm|sum|dma|tile)_\w*?kernel)(?:I(.*?)EEv)?", mangled)
    if not m:
        return mangled[:40]
    flat = re.findall(r"Lb(\d)E|Li(\d+)E|(13__nv_bfloat16)|(f)", m.group(2) or "")
    names = ["f32" if d else ("bf16" if c else a or b) for a, b, c, d in flat]
    return m.group(1) + ("<" + ",".join(names) + ">" if names else "")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on the GPU")
    # the config's precision (full-f32 matmuls and convolutions, TF32 off) on
    # both sides of every comparison; build_model sets it again per model
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
    apply_precision(cfg)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    phase("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
                    f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
                    + " ".join(f"{k}={v}" for k, v in current_precision().items()))

    t0 = time.perf_counter()
    with watchdog("build", 600):
        dcn_cuda.build()
    phase("build", f"{', '.join(src.name for src in dcn_cuda.SOURCES)} -> sm_90a in "
                   f"{time.perf_counter() - t0:.2f} s; nvcc {' '.join(dcn_cuda.NVCC_FLAGS)}")
    for name, info in build_report().items():
        phase("build", f"{name}: {info}")

    with watchdog("kernel", 420):
        fwd = check_kernel()
        check_kernel(DCN_SHAPES, 1)
        check_kernel(FCOS3D_DCN_SHAPES, FCOS3D_BATCH)
    with watchdog("kernel", 300):
        msda_fwd = check_msda()
    with watchdog("slice", 240):
        slice_launches = run_slice()["launches"]
    with watchdog("bwd", 300):
        bwd = check_backward()
    with watchdog("train", 300):
        train = run_train(card)
    with watchdog("eval", 400):
        epilogue = check_epilogue()
        fused_launches = run_eval()
    with watchdog("bevformer", 300):
        bevformer = run_bevformer()
    with watchdog("diag", 600):
        diag = run_diag()
    with watchdog("configs", 300):
        configs = run_configs(card)
    with watchdog("trainer", 400):
        trainer = run_trainer(card)
    with watchdog("modules", 300):
        run_modules(card)
    with watchdog("bench", 300):
        run_bench(card)
    phase("report", f"inference slice dcn_fwd launches {slice_launches}; train phase "
                    + " ".join(f"{k}={v}" for k, v in train["launches"].items())
                    + f"; configs phase: bf16 forwards dcn_fwd={configs['bf16']['forward']}, "
                    "bf16 steps " + " ".join(f"{k}={v}" for k, v in configs["bf16"]["steps"].items())
                    + f", mixed neck dcn_fwd={configs['mixed']}, rerouted by the guard "
                    f"dcn_fwd={configs['guard']}"
                    + "; the kernels line counts the trainer phase's launches (its three CLI "
                    "runs) for dcn_fwd, dcn_bwd_dx and dcn_bwd_dwmo, the fused eval run's for "
                    "dcn_fwd_bn_relu, the bevformer phase's for msda_fwd, and the diag tools' "
                    "for the rest")

    kernels = [
        dict(name="dcn_fwd", source="monoflex_tpu_torch/csrc/dcn_fwd.cu",
             replaces="monoflex_tpu/ops/dcn_pallas_v3.py:155", **fwd),
        dict(name="dcn_bwd_dx", source="monoflex_tpu_torch/csrc/dcn_bwd_dx.cu",
             replaces="monoflex_tpu/ops/dcn_pallas_v3.py:598", **bwd["dx"]),
        dict(name="dcn_bwd_dwmo", source="monoflex_tpu_torch/csrc/dcn_bwd_dwmo.cu",
             replaces="monoflex_tpu/ops/dcn_pallas_v3.py:747", **bwd["dwmo"]),
        dict(name="dcn_fwd_bn_relu", source="monoflex_tpu_torch/csrc/dcn_fwd.cu",
             replaces="monoflex_tpu/ops/dcn_pallas_v3.py:155 (epilogue)", **epilogue),
        dict(name="msda_fwd", source="monoflex_tpu_torch/csrc/msda/msda_fwd.cu",
             replaces="none (the JAX package has no deformable attention)", **msda_fwd),
    ]
    launches = {**{k: trainer[k] for k in ("dcn_fwd", "dcn_bwd_dx", "dcn_bwd_dwmo")},
                "dcn_fwd_bn_relu": fused_launches["dcn_forward_bn_relu"],
                "msda_fwd": bevformer["launches"]}
    diag_sources = {"dcn_fwd[bf16 math]": ("dcn_fwd.cu", "monoflex_tpu/ops/dcn_pallas.py:112"),
                    "dcn_bwd_dx[bf16 math]": ("dcn_bwd_dx.cu",
                                              "monoflex_tpu/ops/dcn_pallas_bwd.py:242"),
                    "dcn_bwd_dwmo[bf16 math]": ("dcn_bwd_dwmo.cu",
                                                "monoflex_tpu/ops/dcn_pallas_bwd.py:281"),
                    "relayout": ("relayout.cu", "tools/transpose_ablate.py:97")}
    for v in ABLATE_VARIANTS:
        diag_sources[f"dcn_ablate[{v}]"] = (
            "dcn_ablate.cu", "tools/fwd_ablate.py:620" if v in ("nomap", "nobcast")
            else "tools/kernel_diag.py:103")
    for name, (src, replaces) in diag_sources.items():
        rec = diag[name]
        launches[name] = rec.pop("launches")
        kernels.append(dict(name=name, source=f"monoflex_tpu_torch/csrc/{src}", replaces=replaces,
                            **rec))
    # no single PyTorch call computes a modulated deformable conv (torchvision,
    # which has one, is not installed on the card's machine), nor the bf16
    # window math or the ablations other than dma (x.clone()); the relayout's
    # is F.pad of the permuted view
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": launches[k["name"]], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k.get("library_ms")}
        for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
