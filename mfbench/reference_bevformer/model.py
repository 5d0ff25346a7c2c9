"""The plain BEVFormer as the benchmark drives it: the model of a
configuration file's ``cfg`` tree in the precision the configuration
states (float32 with TF32 off; under ``TPU.COMPUTE_DTYPE`` "bfloat16" the
port's bf16 mode mirrored, ``bevformer.py``), at the BEV grid and depths
``grid`` gives (and decoder queries), its seeded weights and the benchmark's part of them
(``weights.py``, ``weights_bevformer.py``), and the published decode.

``precision``: "stated", or "fp8", the control of a bfloat16
configuration: every convolution and dense layer that runs in bfloat16
takes its input and kernel rounded to float8 e4m3 with a per-tensor scale
(``reference/model.py::fp8``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..reference.model import fp8, set_precision
from ..reference_fcos3d import fcos3d as trunk
from ..weights import apply_recipe
from ..weights import load_buffers
from ..weights_bevformer import class_bias, perturb_attention, scale_branches
from . import bevformer as plain

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TRANSFER = {"pallas3b": torch.bfloat16}      # the impls that ship x in bf16
# BEV rows, columns, encoder and decoder layers, decoder queries
PUBLISHED_GRID = (200, 200, 6, 6, 900)


def build(tree: Dict, weights: Dict, seed: int, device, precision: str = "stated",
          grid: Tuple[int, ...] = PUBLISHED_GRID):
    """The reference model of ``tree`` on ``device``, in eval mode."""
    t = tree["TPU"]
    impl = t["DCN_FORCE_IMPL"] or "pallas3b"
    h, w, enc, dec, queries = grid
    model = plain.BEVFormer(
        bev_h=h, bev_w=w, encoder_layers=enc, decoder_layers=dec, num_query=queries,
        max_offset=float(t["DCN_MAX_OFFSET"]), transfer_dtype=TRANSFER.get(impl, torch.float32),
        compute_dtype=DTYPES[t["COMPUTE_DTYPE"]],
        pixel_mean=tuple(tree["INPUT"]["PIXEL_MEAN"]), pixel_std=tuple(tree["INPUT"]["PIXEL_STD"]),
        to_bgr=bool(tree["INPUT"]["TO_BGR"]),
        size_divisor=int(tree["DATALOADER"]["SIZE_DIVISIBILITY"]))
    plain.init(model, seed)
    model = model.to(device)
    apply_recipe(model, seed, weights)
    perturb_attention(model, seed, weights)
    scale_branches(model, weights)
    if precision == "fp8":
        for mod in model.modules():
            if isinstance(mod, (trunk.Conv, plain.Linear, plain.MultiheadAttention)) and \
                    mod.compute_dtype == torch.bfloat16:
                mod.fake_quant = fp8
    set_precision(precision)
    return model.eval()


def upload(sample: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in sample.items()}


def decode(cls: torch.Tensor, boxes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The published decode (``bevformer.py::decode``)."""
    return plain.decode(cls, boxes)


@torch.no_grad()
def bn_statistics(tree: Dict, weights: Dict, seed: int, device, sample: Dict,
                  grid: Tuple[int, ...] = PUBLISHED_GRID) -> Dict[str, torch.Tensor]:
    """The trunk's BatchNorm statistics of one sample's images through the
    reference's trunk in train mode (``weights.py::bn_statistics``'s
    reason)."""
    model = build(tree, weights, seed, device, grid=grid)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    model.backbone.train()
    model.features(upload({"image": sample["image"]}, device)["image"])
    out = {n: b.detach().clone() for n, b in model.named_buffers()
           if n.endswith(("running_mean", "running_var"))}
    del model
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


@torch.no_grad()
def fit_class_bias(tree: Dict, weights: Dict, seed: int, device, sample: Dict,
                   buffers: Dict[str, torch.Tensor],
                   grid: Tuple[int, ...] = PUBLISHED_GRID) -> float:
    """The class branches' last bias (``weights_bevformer.py::class_bias``)
    fitted on one sample through the reference, without history."""
    model = build(tree, weights, seed, device, grid=grid)
    load_buffers(model, buffers)
    x = upload({k: v for k, v in sample.items() if k != "scene_start"}, device)
    cls = model(x["image"], x["lidar2img"], x["can_bus"])["cls"]
    bias = model.cls_branches[-1][-1].bias.float()
    del model
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return class_bias(cls.float() - bias, weights)
