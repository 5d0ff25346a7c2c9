"""Class tower, regression towers and edge fusion (counterpart of
``monoflex_tpu/models/heads/predictor.py``).

Submodules carry the reference torch names: ``class_head.{0,1,2}``,
``reg_features.i``, ``reg_heads.i.j`` and ``trunc_{heatmap,offset}_conv``.
The reference's InPlaceABN (BN + leaky ReLU in one module) becomes
``NormAct``, which keeps the BN parameters in slot 1 of each tower so the
final 1x1 conv of ``class_head`` stays at index 2.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.image_ops import gather_edge_features, scatter_add_edge, sigmoid_hm
from ..batchnorm import BatchNorm1d, BatchNorm2d
from .key2channel import Key2Channel


class NormAct(BatchNorm2d):
    """BatchNorm then leaky ReLU (slope 0.01 for InPlaceABN, 0 for ReLU)."""

    def __init__(self, channels: int, negative_slope: float):
        super().__init__(channels, eps=1e-5)
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(super().forward(x), self.negative_slope)


def _tower(cin: int, cout: int, negative_slope: float) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False),
                         NormAct(cout, negative_slope))


def _conv1d_stack(hidden: int, out: int, kernel: int, use_bn: bool,
                  use_relu: bool) -> nn.Sequential:
    """k-tap replicate-padded conv1d -> [BN] -> [ReLU] -> 1x1 conv1d, along
    the boundary chain; slots 0..3 as in the reference."""
    return nn.Sequential(
        nn.Conv1d(hidden, hidden, kernel, padding=kernel // 2, padding_mode="replicate"),
        BatchNorm1d(hidden, eps=1e-5) if use_bn else nn.Identity(),
        nn.ReLU() if use_relu else nn.Identity(),
        nn.Conv1d(hidden, out, 1))


class Predictor(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, head_conv: int,
                 regression_heads: Sequence[Sequence[str]],
                 regression_channels: Sequence[Sequence[int]],
                 leaky: bool = True, init_p: float = 0.01, uncertainty_init: bool = True,
                 enable_edge_fusion: bool = True, edge_kernel_size: int = 3,
                 edge_fusion_bn: bool = True, edge_fusion_relu: bool = False):
        super().__init__()
        slope = 0.01 if leaky else 0.0
        self.regression_heads = [list(g) for g in regression_heads]
        self.head_conv = head_conv
        self.init_p = init_p
        self.uncertainty_init = uncertainty_init
        self.k2c = Key2Channel(regression_heads, regression_channels)

        self.class_head = nn.Sequential(*_tower(in_channels, head_conv, slope),
                                        nn.Conv2d(head_conv, num_classes, 1))
        self.reg_features = nn.ModuleList(
            _tower(in_channels, head_conv, slope) for _ in regression_heads)
        self.reg_heads = nn.ModuleList(
            nn.ModuleList(nn.Conv2d(head_conv, ch, 1) for ch in chans)
            for chans in regression_channels)
        self.enable_edge_fusion = enable_edge_fusion and "3d_offset" in self.k2c
        if self.enable_edge_fusion:
            self.trunc_heatmap_conv = _conv1d_stack(head_conv, num_classes, edge_kernel_size,
                                                    edge_fusion_bn, edge_fusion_relu)
            self.trunc_offset_conv = _conv1d_stack(head_conv, 2, edge_kernel_size,
                                                   edge_fusion_bn, edge_fusion_relu)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The head-specific inits: the class bias at the focal prior
        -log(1/p - 1), uncertainty heads xavier-normal with gain 0.01."""
        self.class_head[2].bias.fill_(-math.log(1.0 / self.init_p - 1.0))
        if not self.uncertainty_init:
            return
        for gi, group in enumerate(self.regression_heads):
            for ki, key in enumerate(group):
                if "uncertainty" in key:
                    w = self.reg_heads[gi][ki].weight
                    fan_in, fan_out = w.shape[1], w.shape[0]
                    std = 0.01 * math.sqrt(2.0 / (fan_in + fan_out))
                    w.copy_(torch.randn(w.shape, generator=generator) * std)

    def forward(self, features: torch.Tensor, edge_indices: Optional[torch.Tensor] = None,
                edge_len: Optional[torch.Tensor] = None) -> Dict[str, object]:
        feat_cls = self.class_head[1](self.class_head[0](features))
        out_cls = self.class_head[2](feat_cls)

        reg_outputs = []
        offset_feature = None
        offset_index = None
        for gi, group in enumerate(self.regression_heads):
            feat = self.reg_features[gi](features)
            for ki, key in enumerate(group):
                if key == "3d_offset":
                    offset_feature = feat
                    offset_index = len(reg_outputs)
                reg_outputs.append(self.reg_heads[gi][ki](feat))

        if self.enable_edge_fusion and edge_indices is not None:
            edge_feat = gather_edge_features((feat_cls, offset_feature), edge_indices)  # (B,E,2h)
            h = self.head_conv
            edge_cls = self.trunc_heatmap_conv(edge_feat[..., :h].transpose(1, 2))
            edge_off = self.trunc_offset_conv(edge_feat[..., h:].transpose(1, 2))
            out_cls = scatter_add_edge(out_cls, edge_indices, edge_cls.transpose(1, 2), edge_len)
            reg_outputs[offset_index] = scatter_add_edge(
                reg_outputs[offset_index], edge_indices, edge_off.transpose(1, 2), edge_len)

        # per-head maps in REGRESSION_HEADS order, as Key2Channel counts them
        return {"cls": sigmoid_hm(out_cls), "reg": tuple(reg_outputs)}


def build_predictor(cfg, in_channels: int = 64) -> Predictor:
    h = cfg.MODEL.HEAD
    if h.USE_NORMALIZATION != "BN":
        raise NotImplementedError(f"MODEL.HEAD.USE_NORMALIZATION {h.USE_NORMALIZATION!r}: only BN")
    return Predictor(
        in_channels=in_channels,
        num_classes=len(cfg.DATASETS.DETECT_CLASSES),
        head_conv=h.NUM_CHANNEL,
        regression_heads=h.REGRESSION_HEADS,
        regression_channels=h.REGRESSION_CHANNELS,
        leaky=bool(cfg.MODEL.INPLACE_ABN),
        init_p=h.INIT_P,
        uncertainty_init=h.UNCERTAINTY_INIT,
        enable_edge_fusion=h.ENABLE_EDGE_FUSION,
        edge_kernel_size=h.EDGE_FUSION_KERNEL_SIZE,
        edge_fusion_bn=h.EDGE_FUSION_NORM == "BN",
        edge_fusion_relu=h.EDGE_FUSION_RELU,
    )
