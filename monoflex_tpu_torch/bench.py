"""Inference throughput of the port on one card, the counterpart of the JAX
package's ``bench.py``::

    python -m monoflex_tpu_torch.bench
    BENCH_DTYPE=bfloat16 python -m monoflex_tpu_torch.bench

``runs/monoflex.yaml`` with weights from a seeded ``torch.Generator``
(``build_model(seed=0)``; the offset/mask convs start at zero, as the JAX
``model.init`` leaves them), batch ``BENCH_BATCH`` (8) of uint8 384x1280
images from ``data/synthetic.py::make_inference_batch``, moved to the card
before timing.  The timed function is the forward and the decode
(``PostProcessor``) in eval mode under ``torch.inference_mode``:
``WARMUP_CALLS`` untimed calls, then ``BENCH_ITERS`` (20) calls between two
``torch.cuda.synchronize()``.

The last line is the JAX line, with its keys::

    {"metric": "inference_images_per_sec_per_chip", "value": ..., "unit": "img/s",
     "vs_baseline": ...}

``vs_baseline`` is over the JAX package's 33 img/s (the V100-era anchor,
BASELINE.md).  Earlier lines give the card's name and power limit as
nvidia-smi reports them, the precision flags, the latency of one batch and
the DCN forward kernel's launches per call.

Environment knobs, as ``bench.py:62-81`` reads them: ``BENCH_DCN_IMPL``
(shift | gather), ``BENCH_KERNEL_VERSION``, ``BENCH_IMPL_PER_STAGE``
(comma-separated, ida_0 first), ``BENCH_DTYPE``, ``BENCH_FUSE_BN_RELU``
(1 = on), ``BENCH_BATCH``, ``BENCH_ITERS`` and ``BENCH_PROFILE=<dir>`` (a
``torch.profiler`` trace of the timed calls written there, and the device's
busy ms and idle share printed).  With ``MONOFLEX_TORCH_LAUNCH_LOG=<path>``
the kernels' launch counts of the whole run are written there at the end.

There is no CPU fallback: without a card the error line (``"value": null``)
is printed and the exit code is 1; a card whose first tiny op does not
finish within 180 s gives the error line and exit code 3.
``main(device="cpu")`` runs the same program on the CPU for tests.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import threading
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .config import get_cfg_defaults
from .data.synthetic import make_inference_batch
from .decode.postprocessor import PostProcessor
from .models.detector import build_model
from .ops import dcn_cuda
from .tools import write_launch_log
from .tools.profile_split import busy_ms
from .utils.precision import current_precision

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = "inference_images_per_sec_per_chip"
# the JAX package's anchor: ~0.03 s/img on a V100-class GPU (bench.py:26)
V100_BASELINE_IMG_PER_S = 33.0
# Untimed calls before the timed loop.  The JAX bench's one warm-up call
# compiles; here the first calls of each convolution shape run cuDNN's
# autotune (CUDNN_BENCHMARK, utils/precision.py), so a few calls are made
# before timing starts, whatever the config.
WARMUP_CALLS = 3
DEFAULT_BATCH, DEFAULT_ITERS = 8, 20
WATCHDOG_S = 180

Tensors = Dict[str, torch.Tensor]


def error_line(metric: str, message: str) -> str:
    """The JAX harness's error line: the metric's keys with null values."""
    return json.dumps({"metric": metric, "value": None, "unit": "img/s", "vs_baseline": None,
                       "error": message})


def result_line(metric: str, images: int, seconds: float, baseline: float) -> str:
    """The JAX harness's result line (the same rounding)."""
    img_per_s = images / seconds
    return json.dumps({"metric": metric, "value": round(img_per_s, 2), "unit": "img/s",
                       "vs_baseline": round(img_per_s / baseline, 3)})


def require_device(device: str, metric: str) -> torch.device:
    """The device to run on: "cuda" needs a card (no fallback): without one,
    print the error line and exit 1."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(error_line(metric, "no CUDA device; the port's benchmarks run only on the GPU"),
              flush=True)
        raise SystemExit(1)
    return device


def device_watchdog(metric: str, seconds: float = WATCHDOG_S) -> None:
    """A tiny op on the card must finish within ``seconds``; otherwise print
    the error line and end the process with code 3 (``bench.py:28-50``)."""
    done = threading.Event()

    def killer():
        if not done.wait(seconds):
            print(error_line(metric, f"device probe hung >{seconds}s"), flush=True)
            os._exit(3)

    threading.Thread(target=killer, daemon=True).start()
    torch.ones((8, 8), device="cuda").add_(1.0)
    torch.cuda.synchronize()
    done.set()


def card_line(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if device.type != "cuda":
        return "card: none (cpu)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return f"card: {smi}"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def bench_config(env: Mapping[str, str] = os.environ):
    """``runs/monoflex.yaml`` with the BENCH_* knobs of ``bench.py:62-81``."""
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
    impl = env.get("BENCH_DCN_IMPL")
    if impl == "shift":
        cfg.TPU.USE_PALLAS_DCN = False
    elif impl == "gather":
        cfg.TPU.USE_PALLAS_DCN = False
        cfg.MODEL.BACKBONE.CONV_BODY = "dla34"
        # The JAX bench gets "gather" from default_dcn_impl, which picks it
        # on any backend but the TPU.  The port resolves the impl as the TPU
        # does (models/backbone/dla.py::resolve_dcn_stages), where those two
        # keys alone give "shift", so the impl is named here.
        cfg.TPU.DCN_FORCE_IMPL = "gather"
    if env.get("BENCH_KERNEL_VERSION"):
        cfg.TPU.DCN_KERNEL_VERSION = int(env["BENCH_KERNEL_VERSION"])
    if env.get("BENCH_IMPL_PER_STAGE"):
        cfg.TPU.DCN_IMPL_PER_STAGE = tuple(env["BENCH_IMPL_PER_STAGE"].split(","))
    if env.get("BENCH_DTYPE"):
        cfg.TPU.COMPUTE_DTYPE = env["BENCH_DTYPE"]
    if env.get("BENCH_FUSE_BN_RELU"):
        cfg.TPU.DCN_FUSE_BN_RELU = env["BENCH_FUSE_BN_RELU"] == "1"
    return cfg


def infer(model: torch.nn.Module, post: PostProcessor, batch: Tensors
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The timed function: forward and decode, (rows (B, 50, 14), valid)."""
    with torch.inference_mode():
        out = model(batch["image"], batch["edge_indices"], batch["edge_len"])
        result, valid, _ = post(out, batch)
    return result, valid


def fwd_launches() -> int:
    """Launches of the DCN forward kernel, with or without the fused epilogue."""
    return dcn_cuda.dcn_forward.launches + dcn_cuda.dcn_forward_bn_relu.launches


def timed_loop(fn: Callable[[], object], iters: int, device: torch.device,
               profile_dir: Optional[str], label: str) -> float:
    """Seconds for ``iters`` calls of ``fn`` between two synchronisations;
    with ``profile_dir``, under a torch.profiler trace written there, whose
    device busy ms and idle share are printed."""
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with (profile(activities=activities) if profile_dir else contextlib.nullcontext()) as prof:
        sync(device)
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(device)
        elapsed = time.perf_counter() - start
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"{label}_trace.json")
        prof.export_chrome_trace(path)
        print(f"profile: {trace_summary(prof, elapsed * 1e3, iters)}; trace {path}", flush=True)
    return elapsed


def trace_summary(prof, wall_ms: float, iters: int) -> str:
    """Device busy ms per call (the union of the device's activity) and the
    idle share of the traced wall time."""
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        return f"{iters} calls in {wall_ms:.3f} ms; device busy not measured (no device records)"
    busy = busy_ms(spans)
    return (f"{iters} calls in {wall_ms:.3f} ms; device busy {busy / iters:.3f} ms a call, "
            f"idle share {1 - busy / wall_ms:.4f}")


def main(device: str = "cuda", env: Mapping[str, str] = os.environ) -> None:
    device = require_device(device, METRIC)
    if device.type == "cuda":
        device_watchdog(METRIC)
    cfg = bench_config(env)
    batch_size = int(env.get("BENCH_BATCH", DEFAULT_BATCH))
    iters = int(env.get("BENCH_ITERS", DEFAULT_ITERS))
    model = build_model(cfg, device=device, seed=0)
    post = PostProcessor(cfg)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in make_inference_batch(batch_size).items()}
    print(card_line(device), flush=True)
    print("precision: " + " ".join(f"{k}={v}" for k, v in current_precision().items())
          + f" compute_dtype={cfg.TPU.COMPUTE_DTYPE}", flush=True)

    for _ in range(WARMUP_CALLS):
        infer(model, post, batch)
    before = fwd_launches()
    elapsed = timed_loop(lambda: infer(model, post, batch), iters, device,
                         env.get("BENCH_PROFILE"), "bench")
    print(f"batch {batch_size}: {elapsed * 1e3 / iters:.3f} ms a batch over {iters} calls "
          f"after {WARMUP_CALLS} warm-up calls; dcn_fwd launches a call "
          f"{(fwd_launches() - before) / iters:g}", flush=True)
    write_launch_log()
    print(result_line(METRIC, batch_size * iters, elapsed, V100_BASELINE_IMG_PER_S), flush=True)


if __name__ == "__main__":
    main()
