"""The benchmark's part of BEVFormer's seeded weights, beyond ``weights.py``'s
(the trunk's DCN offset convs, BN biases), applied by parameter name to the
program and to the reference alike.

The published init leaves every deformable attention's sampling-offset and
attention-weight projections at zero: each query would sample the same
fixed ring of points (the offset bias) with equal weights, whatever it
holds, which trained weights never do.  ``perturb_attention`` gives those
two kernels seeded values N(0, 1) x scale / sqrt(fan_in), drawn on the
model's device by one generator call over the parameters in name order, so
that both sides receive the same values.  At the LayerNorm'd queries
(unit variance) an offset then spreads with a standard deviation of
``sampling_offset_scale`` cells of its level (BEV cells in the temporal
self-attention and the decoder, feature-map pixels in the spatial
cross-attention) about the published ring, and the softmax's logits with
``attention_weight_scale``.

The seeded branches are no trained head either.  Each decoder layer's
regression branch moves the reference points by its codes 0, 1 and 4 in
inverse-sigmoid units: at xavier weights by a standard deviation of
0.26-0.72, tens of BEV cells a layer at the grid's centre, where a trained
decoder refines by a cell or two; the sampling locations of the next layer
then swing by cells with the last bits of the queries, and every gap after
the decoder reads that swing (a float8 control read only 3x a sound run's
class-logit gap, against 6x its BEV gap).  ``scale_branches`` multiplies those three rows of every
regression branch's last layer by ``refinement_scale``, and every class
branch's last kernel by ``class_weight_scale``, with its bias at
``class_bias`` (the published prior until it is fitted), both sides
alike.  At the published prior a seeded head scores no (query, class) pair
over 0.14, and its 300 best are near-tied; ``class_bias`` is fitted to the
seed's first sample (``reference_bevformer/model.py::fit_class_bias``) so
that ``confident_pairs`` pairs score over ``confident_score``, as a trained
head does on a sample's objects.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

SALT = 0x6266     # keeps this draw apart from the other seeded draws of the seed
SUFFIXES = {"sampling_offsets.weight": "sampling_offset_scale",
            "attention_weights.weight": "attention_weight_scale"}
REFINED = (0, 1, 4)       # the box codes that move the reference points: x, y, z


@torch.no_grad()
def perturb_attention(model: nn.Module, seed: int, weights: Dict) -> int:
    """Returns the number of tensors set."""
    params = sorted((n, p) for n, p in model.named_parameters() if n.endswith(tuple(SUFFIXES)))
    if not params:
        return 0
    device = params[0][1].device
    g = torch.Generator(device=device).manual_seed((int(seed) ^ SALT) % 2 ** 63)
    draw = torch.randn(sum(p.numel() for _, p in params), generator=g, device=device)
    at = 0
    for name, p in params:
        scale = weights[next(v for k, v in SUFFIXES.items() if name.endswith(k))]
        p.copy_(draw[at:at + p.numel()].view(p.shape) * (scale / p.shape[1] ** 0.5))
        at += p.numel()
    return len(params)


@torch.no_grad()
def scale_branches(model: nn.Module, weights: Dict) -> None:
    """The branches' last layers (module docstring)."""
    for branch in model.reg_branches:
        branch[-1].weight[list(REFINED)] *= float(weights["refinement_scale"])
    for branch in model.cls_branches:
        branch[-1].weight *= float(weights["class_weight_scale"])
        if "class_bias" in weights:         # absent in the fit's own build
            branch[-1].bias.fill_(float(weights["class_bias"]))


def class_bias(logits: torch.Tensor, weights: Dict) -> float:
    """The class bias at which ``confident_pairs`` of the (query, class)
    pairs of the bias-free ``logits`` score over ``confident_score``: midway
    between the last such pair's logit and the next one's."""
    k, score = int(weights["confident_pairs"]), float(weights["confident_score"])
    top = logits.float().flatten().topk(k + 1).values
    return math.log(score / (1 - score)) - float(top[k - 1] + top[k]) / 2
