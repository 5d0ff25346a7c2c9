"""The plain FCOS3D as the benchmark drives it: the model of a configuration
file's ``cfg`` tree in the precision the configuration states (float32 with
TF32 off; under ``TPU.COMPUTE_DTYPE`` "bfloat16" the port's bf16 mode
mirrored, ``fcos3d.py``), its seeded weights and the benchmark's part of
them (``weights.py``, ``weights_fcos3d.py``), and the published decode.

``precision``: "stated", or "fp8", the control of a bfloat16 configuration:
every convolution that runs in bfloat16 takes its input and kernel rounded
to float8 e4m3 with a per-tensor scale (``reference/model.py::fp8``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..reference.model import fp8, set_precision
from ..weights import apply_recipe
from ..weights_fcos3d import fit, head_biases
from . import fcos3d as plain

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TRANSFER = {"pallas3b": torch.bfloat16}      # the impls that ship x in bf16


def build(tree: Dict, weights: Dict, seed: int, device, precision: str = "stated"):
    """The reference model of ``tree`` on ``device``, in eval mode."""
    t = tree["TPU"]
    impl = t["DCN_FORCE_IMPL"] or "pallas3b"
    model = plain.FCOS3D(
        max_offset=float(t["DCN_MAX_OFFSET"]), transfer_dtype=TRANSFER.get(impl, torch.float32),
        compute_dtype=DTYPES[t["COMPUTE_DTYPE"]],
        pixel_mean=tuple(tree["INPUT"]["PIXEL_MEAN"]), pixel_std=tuple(tree["INPUT"]["PIXEL_STD"]),
        to_bgr=bool(tree["INPUT"]["TO_BGR"]),
        size_divisor=int(tree["DATALOADER"]["SIZE_DIVISIBILITY"]))
    plain.init(model, seed)
    model = model.to(device)
    apply_recipe(model, seed, weights)
    head_biases(model, weights)
    if precision == "fp8":
        for mod in model.modules():
            if isinstance(mod, plain.Conv) and mod.compute_dtype == torch.bfloat16:
                mod.fake_quant = fp8
    set_precision(precision)
    return model.eval()


def upload(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def decode(maps: List[torch.Tensor], cam: torch.Tensor) -> Dict[str, object]:
    """The published decode (mmdetection3d's test_cfg, ``fcos3d.py::decode``)."""
    return plain.decode(maps, cam)


@torch.no_grad()
def fit_head_biases(tree: Dict, weights: Dict, seed: int, device, batch: Dict,
                    buffers: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The class and depth biases of ``weights_fcos3d.fit`` on the head maps
    of one batch of the cell's inputs through the reference (with the
    trunk's BN statistics ``buffers``)."""
    from ..weights import load_buffers

    start = {k: v for k, v in weights.items() if k not in ("cls_bias", "depth_bias")}
    model = build(tree, start, seed, device)
    load_buffers(model, buffers)
    maps = model(upload(batch, device)["image"])
    out = fit(maps, plain.field_slices(), plain.NMS_PRE, plain.SCORE_THR, weights)
    del model, maps
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


@torch.no_grad()
def bn_statistics(tree: Dict, weights: Dict, seed: int, device, batch: Dict
                  ) -> Dict[str, torch.Tensor]:
    """The trunk's BatchNorm statistics of one batch of the cell's inputs
    through the reference in train mode (``weights.py::bn_statistics``'s
    reason: at their seeded init an eval forward shrinks every map to its
    bias)."""
    model = build(tree, weights, seed, device)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    model.train()
    model(upload(batch, device)["image"])
    out = {n: b.detach().clone() for n, b in model.named_buffers()
           if n.endswith(("running_mean", "running_var"))}
    del model
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out
