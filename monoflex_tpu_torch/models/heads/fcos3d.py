"""FCOS3D's head, shared over the pyramid's levels (mmdetection3d's
``FCOSMono3DHead`` as the nuScenes config builds it: ``stacked_convs=2``,
``dcn_on_last_conv``, GroupNorm(32), ``conv_bias``, ``centerness_on_reg``).

Two towers read each level: ``cls_convs`` and ``reg_convs``, each a 3x3 conv
then a DCNv2 (``dla.py``'s module), each followed by GroupNorm and ReLU.  A
branch is a 3x3 conv of ``BRANCH`` channels with GN and ReLU, then a 1x1
output conv:

- from the class tower: the class logits (``conv_cls``) and the attribute
  logits (``conv_attr``);
- from the regression tower: the 2D offset (2), depth (1), size (3) and
  rotation (1) (``conv_regs[0:4]``), the direction logits (``conv_dir_cls``),
  the velocity (2, ``conv_regs[4]``, a 1x1 on the tower with no branch) and
  the centerness logit (``conv_centerness``, after a 64-channel branch).

Each level's offset, depth and size are multiplied by its own learned
scale (``scales[level]``, initialised to 1).  Decoding (the exponentials,
the stride, the camera) is the decoder's (``decode/fcos3d.py``).

Under ``TPU.COMPUTE_DTYPE`` "bfloat16" the towers and the branch convs run
in bf16 and the 1x1 output convs in f32 on the features cast up, as the
MonoFlex predictor splits them.  Each level's output is one f32 map of
``CHANNELS`` channels in the order of ``FIELDS``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
from torch import nn

from ..backbone.dla import DCN, DCNSpec
from ..layers import Conv2d, GroupNorm

GN_EPS = 1e-5      # mmcv's GroupNorm
BRANCH = 256
CENTERNESS_BRANCH = 64
REG_DIMS = (2, 1, 3, 1, 2)      # offset, depth, size, rotation, velocity
NUM_CLASSES = 10                # nuScenes' detection classes
NUM_ATTRS = 9                   # nuScenes' attributes
STRIDES = (8, 16, 32, 64, 128)  # P3-P7
INIT_P = 0.01                   # the class bias's focal prior


def _fields() -> Dict[str, slice]:
    widths = [("cls", NUM_CLASSES), ("offset", 2), ("depth", 1), ("size", 3), ("rot", 1),
              ("velo", 2), ("dir", 2), ("attr", NUM_ATTRS), ("centerness", 1)]
    out, at = {}, 0
    for name, n in widths:
        out[name] = slice(at, at + n)
        at += n
    return out


FIELDS = _fields()      # channel slices of a level's output map, by field
CHANNELS = FIELDS["centerness"].stop


class ConvGNReLU(nn.Module):
    """A 3x3 conv (or DCN) with bias, GroupNorm(32) and ReLU (mmcv's
    ``ConvModule``: ``conv``, ``gn``)."""

    def __init__(self, cin: int, cout: int, dcn: DCNSpec = None):
        super().__init__()
        self.conv = DCN(cin, cout, dcn) if dcn is not None else Conv2d(cin, cout, 3, padding=1)
        self.gn = GroupNorm(cout, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.gn(self.conv(x)))


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


def _tower(cin: int, channels: int, dcn: DCNSpec) -> nn.ModuleList:
    return nn.ModuleList([ConvGNReLU(cin, channels), ConvGNReLU(channels, channels, dcn)])


def _branch(channels: int, width: int = BRANCH) -> nn.ModuleList:
    return nn.ModuleList([ConvGNReLU(channels, width)])


def _run(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        x = layer(x)
    return x


class FCOS3DHead(nn.Module):
    def __init__(self, in_channels: int, dcn: DCNSpec):
        super().__init__()
        self.cls_convs = _tower(in_channels, in_channels, dcn)
        self.reg_convs = _tower(in_channels, in_channels, dcn)
        self.conv_cls_prev = _branch(in_channels)
        self.conv_cls = nn.Conv2d(BRANCH, NUM_CLASSES, 1)
        self.conv_reg_prevs = nn.ModuleList(
            _branch(in_channels) if i < len(REG_DIMS) - 1 else nn.ModuleList()
            for i in range(len(REG_DIMS)))
        self.conv_regs = nn.ModuleList(
            nn.Conv2d(BRANCH if i < len(REG_DIMS) - 1 else in_channels, d, 1)
            for i, d in enumerate(REG_DIMS))
        self.conv_dir_cls_prev = _branch(in_channels)
        self.conv_dir_cls = nn.Conv2d(BRANCH, 2, 1)
        self.conv_attr_prev = _branch(in_channels)
        self.conv_attr = nn.Conv2d(BRANCH, NUM_ATTRS, 1)
        self.conv_centerness_prev = _branch(in_channels, CENTERNESS_BRANCH)
        self.conv_centerness = nn.Conv2d(CENTERNESS_BRANCH, 1, 1)
        self.scales = nn.ModuleList(nn.ModuleList(Scale() for _ in range(3))
                                    for _ in STRIDES)

    def towers(self) -> List[nn.Module]:
        """The modules that run in the compute dtype (all but the 1x1 outputs)."""
        return [self.cls_convs, self.reg_convs, self.conv_cls_prev, *self.conv_reg_prevs,
                self.conv_dir_cls_prev, self.conv_attr_prev, self.conv_centerness_prev]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """The class bias at the focal prior -log(1/p - 1); every scale 1."""
        self.conv_cls.bias.fill_(-math.log(1.0 / INIT_P - 1.0))
        for level in self.scales:
            for s in level:
                s.scale.fill_(1.0)

    def forward_level(self, x: torch.Tensor, level: int) -> torch.Tensor:
        cls_feat = _run(self.cls_convs, x)
        reg_feat = _run(self.reg_convs, x)
        cls = self.conv_cls(_run(self.conv_cls_prev, cls_feat).float())
        regs = [conv(_run(prev, reg_feat).float())
                for prev, conv in zip(self.conv_reg_prevs, self.conv_regs)]
        scale = self.scales[level]
        regs[0], regs[1], regs[2] = scale[0](regs[0]), scale[1](regs[1]), scale[2](regs[2])
        direction = self.conv_dir_cls(_run(self.conv_dir_cls_prev, reg_feat).float())
        attr = self.conv_attr(_run(self.conv_attr_prev, cls_feat).float())
        centerness = self.conv_centerness(_run(self.conv_centerness_prev, reg_feat).float())
        return torch.cat([cls, *regs, direction, attr, centerness], dim=1)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [self.forward_level(x, i) for i, x in enumerate(feats)]
