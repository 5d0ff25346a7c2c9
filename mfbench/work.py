"""The yardstick's arithmetic: the chip's peaks, the work of a forward and a
training step (FLOPs counted on the frozen reference from shapes alone), and
each DCN layer's roofline bound.  Nothing here depends on how the program
implements an operation."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class DcnLayer:
    """One modulated 3x3 DCN call: batch, map, input and output channels."""
    B: int
    H: int
    W: int
    C: int
    Co: int

    @property
    def pixels(self) -> int:
        return self.B * self.H * self.W

    def contraction_flops(self) -> float:
        """One contraction over the 9 taps x C channels per output pixel."""
        return 2.0 * 9 * self.C * self.Co * self.pixels


def fwd_work(layer: DcnLayer, x_bytes: int) -> Dict[str, float]:
    """The forward: one contraction; x, offsets, mask, W and bias read once,
    the f32 output written once (``chip_smoke.py::dcn_work``'s bytes)."""
    n, f32 = layer.pixels, 4
    nbytes = (n * layer.C * x_bytes + n * 27 * f32 + 9 * layer.C * layer.Co * f32
              + layer.Co * f32 + n * layer.Co * f32)
    return {"flops": layer.contraction_flops(), "bytes": float(nbytes)}


def bwd_work(layer: DcnLayer, x_bytes: int) -> Dict[str, float]:
    """The backward: two contractions, u = W g at every sampled position
    (which dx scatters and the offset and mask derivatives read) and dW;
    read x, offsets, mask, W and g once, write dx, the offset and mask
    derivatives and dW once."""
    n, f32 = layer.pixels, 4
    om = n * 27 * f32
    w = 9 * layer.C * layer.Co * f32
    nbytes = (n * layer.C * x_bytes + om + w + n * layer.Co * f32     # inputs
              + n * layer.C * x_bytes + om + w)                       # dx, d(offset, mask), dW
    return {"flops": 2 * layer.contraction_flops(), "bytes": float(nbytes)}


def bound_s(work: Dict[str, float]) -> float:
    """The least time the chip could take: operations at the bf16 dense
    peak or bytes at the memory rate, whichever is longer."""
    return max(work["flops"] / PEAK_BF16_FLOPS, work["bytes"] / PEAK_HBM_BYTES_PER_S)


def layers_bound_s(layers: List[DcnLayer], x_bytes: int, kind: str) -> float:
    fn = fwd_work if kind == "fwd" else bwd_work
    return sum(bound_s(fn(layer, x_bytes)) for layer in layers)


def dcn_layers(model: torch.nn.Module, run) -> List[DcnLayer]:
    """The DCN calls of one ``run()`` of ``model`` (a module with DCN
    submodules holding ``weight`` (Co, C, 3, 3)), from forward hooks."""
    from .reference.dla import DCN

    seen: List[DcnLayer] = []

    def hook(mod, args, _out):
        B, C, H, W = args[0].shape
        seen.append(DcnLayer(B, H, W, C, mod.weight.shape[0]))

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, DCN)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return seen


def tensors(tree) -> List[torch.Tensor]:
    """Every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for item in items if isinstance(item, (dict, list, tuple, torch.Tensor))
            for t in tensors(item)]


def meta_inputs(batch: int, height: int, width: int, down_ratio: int = 4) -> Dict:
    out_h, out_w = height // down_ratio, width // down_ratio
    e = 2 * (out_h + out_w)
    return {"image": torch.zeros(batch, height, width, 3, dtype=torch.uint8, device="meta"),
            "edge_indices": torch.zeros(batch, e, 2, dtype=torch.int32, device="meta"),
            "edge_len": torch.zeros(batch, dtype=torch.int32, device="meta")}


def count_work(cfg, batch: int, height: int, width: int) -> Dict[str, object]:
    """FLOPs per image of a forward and of a training step (forward and
    backward) of the frozen reference at these shapes, counted by
    ``FlopCounterMode`` on meta tensors (no arithmetic runs), and the DCN
    calls of one forward.  The training step's backward starts from the sum
    of every head output, which reaches every convolution as the loss does
    (the loss's own products are a few thousand FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.detector import build_model

    model = build_model(cfg, device="meta", use_dcn_kernel=False)
    x = meta_inputs(batch, height, width, cfg.MODEL.BACKBONE.DOWN_RATIO)

    def forward():
        return model(x["image"], x["edge_indices"], x["edge_len"])

    model.eval()
    with torch.no_grad(), FlopCounterMode(display=False) as fwd:
        layers = dcn_layers(model, forward)
    model.train()
    with FlopCounterMode(display=False) as train:
        out = forward()
        sum(t.float().sum() for t in tensors(out)).backward()
    return {"forward_flops_per_image": fwd.get_total_flops() / batch,
            "train_flops_per_image": train.get_total_flops() / batch,
            "dcn_layers": [list(vars(layer).values()) for layer in layers]}
