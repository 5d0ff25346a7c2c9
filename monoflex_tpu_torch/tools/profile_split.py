"""Where the device time of the port's inference pass and training step goes,
from a torch.profiler trace of the card.

    python -m monoflex_tpu_torch.tools.profile_split [--batch 8] [--iters 5]

Builds ``runs/monoflex.yaml`` at 384x1280 with seeded weights (the
offset/mask convs perturbed off zero, as chip_smoke.py does, so offsets are
fractional), warms up, then traces ``--iters`` forward+decode passes under
``torch.inference_mode`` and ``--iters`` training steps (AdamW).  Prints one
JSON line per path: wall ms per pass or step (host clock around synchronised
work, untraced), busy ms (the union of device activity in a trace of the
device only), the idle share of the traced wall time, peak device memory,
and device ms per pass or step by kernel group (a group is a set of kernel
name patterns; eval-mode BatchNorm runs as elementwise kernels).
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..config import get_cfg_defaults
from ..data.synthetic import make_inference_batch, make_train_batch
from ..decode.postprocessor import PostProcessor
from ..losses.loss_computation import LossComputer
from ..models.detector import build_model
from ..train.solver import build_optimizer
from ..train.train_step import TrainState, make_train_step
from . import require_cuda
from .step_drift import perturb_offset_convs

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# kernel name -> group, first match wins (names as the H100's libraries give them)
GROUPS = (
    ("dcn_fwd", ("dcn_fwd_kernel", "fwd_weight_image")),
    ("dcn_bwd_dx", ("dcn_bwd_dx",)),
    ("dcn_bwd_dwmo", ("dcn_bwd_mo", "dcn_bwd_dw", "dwmo_weight_image")),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw", "transpose", "Transpose")),
    ("convolutions (cuDNN/cuBLAS)", ("conv", "Conv", "xmma", "gemm", "Gemm", "sm90_", "sm80_",
                                     "cutlass", "cudnn", "dgrad", "wgrad")),
    ("batch norm", ("batch_norm", "bn_", "welford", "Welford")),
    ("optimizer", ("multi_tensor", "foreach", "adam", "Adam")),
    ("reductions", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized", "unrolled")),
    ("copies", ("Memcpy", "Memset", "copy", "Copy")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def busy_ms(spans: List[Tuple[int, int]]) -> float:
    """Length of the union of [start, end) spans, in ms (spans in us)."""
    total, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def split(fn: Callable[[], None], iters: int) -> Dict[str, object]:
    """Wall ms per call untraced, then one trace of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) * 1e3 / iters
    groups: Dict[str, float] = {}
    spans = []
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        start, end = event.time_range.start, event.time_range.end
        spans.append((start, end))
        key = group_of(event.name)
        groups[key] = groups.get(key, 0.0) + (end - start) / 1e3 / iters
    busy = busy_ms(spans) / iters
    return {"wall_ms": wall, "traced_wall_ms": traced_wall, "busy_ms": busy,
            "idle_share": 1 - busy / traced_wall,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "device_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args()
    require_cuda("profile_split")
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
    model = build_model(cfg, device="cuda", seed=0)
    card = f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"

    perturb_offset_convs(model, seed=1, weight_scale=2.0)
    post = PostProcessor(cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_inference_batch(args.batch).items()}

    def infer():
        with torch.inference_mode():
            out = model(batch["image"], batch["edge_indices"], batch["edge_len"])
            post(out, batch)

    rec = split(infer, args.iters)
    print(json.dumps({"path": "inference", "batch": args.batch, "device": card,
                      "img_per_s": args.batch / rec["wall_ms"] * 1e3, **rec}), flush=True)

    # train mode, with the milder offset convs of chip_smoke.py's train phase
    perturb_offset_convs(model, seed=1, weight_scale=0.2)
    train_batch = {k: torch.from_numpy(v).cuda()
                   for k, v in make_train_batch(args.batch).items()}
    optimizer, _, _ = build_optimizer(cfg, model)
    step = make_train_step(model, LossComputer(cfg), optimizer)
    state = [TrainState()]

    def train():
        state[0], _ = step(state[0], train_batch)

    rec = split(train, args.iters)
    print(json.dumps({"path": "train_step", "batch": args.batch, "device": card,
                      "img_per_s": args.batch / rec["wall_ms"] * 1e3, **rec}), flush=True)


if __name__ == "__main__":
    main()
