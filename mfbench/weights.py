"""The benchmark's part of the seeded weights.

The model's own seeded init leaves every DCN's offset/mask conv at zero, so
every sample would land on an integer pixel and the mask would be 0.5, which
trained weights never give (trained offsets reach 1-25 px, median by layer;
``docs/offset_stats_synth800.json``).  ``perturb_offset_convs`` gives those
convs seeded weights, as ``monoflex_tpu_torch/tools/step_drift.py`` does,
drawn on the model's device by one generator call, so the program and the
reference receive the same values on the same device.  An inference cell's
model also takes ``bn_statistics``, worked out by the reference and handed
to both sides.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

SALT = 0x6D66  # keeps this draw apart from the model's own init of the same seed


def offset_conv_params(model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """Every DCN offset/mask conv's weight and bias, by name, in module order."""
    return [(n, p) for n, p in model.named_parameters() if ".conv_offset_mask." in n]


@torch.no_grad()
def perturb_offset_convs(model: nn.Module, seed: int, weight_scale: float,
                         bias_scale: float) -> int:
    """weight ~ N(0, 1) * weight_scale / sqrt(fan_in), bias ~ N(0, 1) *
    bias_scale; returns the number of tensors set."""
    params = offset_conv_params(model)
    if not params:
        return 0
    device = params[0][1].device
    g = torch.Generator(device=device).manual_seed((int(seed) ^ SALT) % 2 ** 63)
    draw = torch.randn(sum(p.numel() for _, p in params), generator=g, device=device)
    at = 0
    for name, p in params:
        part = draw[at:at + p.numel()].view(p.shape)
        at += p.numel()
        scale = (weight_scale / p[0].numel() ** 0.5) if p.dim() > 1 else bias_scale
        p.copy_(part * scale)
    return len(params)


@torch.no_grad()
def shift_bn_bias(model: nn.Module, value: float) -> None:
    """Every BatchNorm's bias (beta) set to ``value``.  With the seeded
    init's zero beta the network is chaotic: a rounding in the trunk's
    first layer grows layer by layer to an O(1) change of the head maps,
    under bf16 a 100% gap to the float32 reference, whatever the program
    does.  A positive beta keeps most ReLU inputs positive, and the
    network in the ordered regime a trained one is in."""
    from torch.nn.modules.batchnorm import _BatchNorm

    for m in model.modules():
        if isinstance(m, _BatchNorm):
            m.bias.fill_(value)


def apply_recipe(model: nn.Module, seed: int, weights: Dict) -> None:
    """The benchmark's part of the weights, on a model built from the seed."""
    perturb_offset_convs(model, seed, weights["offset_conv_weight_scale"],
                         weights["offset_conv_bias_scale"])
    shift_bn_bias(model, weights["bn_bias"])


@torch.no_grad()
def bn_statistics(tree: Dict, weights: Dict, seed: int, device, batch: Dict) -> Dict[str, torch.Tensor]:
    """BatchNorm running statistics as a trained model carries them: those
    of one batch of the cell's inputs through the reference in
    train mode.  At their seeded init (mean 0, variance 1) an eval-mode
    forward shrinks the activations layer by layer until every head output
    sits at its bias: every heatmap score at the prior, 1e-5 apart, so the
    decode's top-k would pick among rounding noise."""
    from torch.nn.modules.batchnorm import _BatchNorm

    from .reference import model as ref

    model, _ = ref.build(tree, weights, seed, device)
    bns = [m for m in model.modules() if isinstance(m, _BatchNorm)]
    for m in bns:
        m.momentum = 1.0
    model.train()
    x = ref.upload(batch, device)
    model(x["image"], x.get("edge_indices"), x.get("edge_len"))
    out = {n: b.detach().clone() for n, b in model.named_buffers()
           if n.endswith(("running_mean", "running_var"))}
    del model, x
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


@torch.no_grad()
def load_buffers(model: nn.Module, buffers: Dict[str, torch.Tensor]) -> None:
    own = dict(model.named_buffers())
    if set(buffers) - set(own):
        raise KeyError(f"buffers the model lacks: {sorted(set(buffers) - set(own))[:3]}")
    for name, value in buffers.items():
        own[name].copy_(value)
