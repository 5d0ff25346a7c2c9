"""FCOS3D's trunk: a caffe-style ResNet-101 whose stages 3 and 4 run a
modulated DCNv2 as every bottleneck's 3x3 (mmdetection's ``ResNet(depth=101,
style="caffe", dcn=DCNv2, stage_with_dcn=(False, False, True, True))``, as
FCOS3D's nuScenes config builds it).

"Caffe" puts a stage's stride on the first bottleneck's 1x1 conv, so every
3x3 (and every DCN) has stride 1, as the port's DCN requires.  The stem is a
7x7/2 conv, BN, ReLU and a 3x3/2 max pool; the stages hold ``BLOCKS``
bottlenecks of width 64, 128, 256, 512 and expansion 4, the first of each
with a 1x1 projection and BN on its shortcut.  The BatchNorms are frozen
(eval statistics: the model is built for inference).  The DCN is
``dla.py``'s module, whose ``spec`` routes it to the kernel, with its
offset/mask conv and its own bias (zero, as the published DCN has none).
Under ``TPU.COMPUTE_DTYPE`` "bfloat16" the convolutions, BN outputs and
residual sums run in bf16 (``models/layers.py``); a DCN returns f32, which
its BN casts back.  ``forward`` returns C3, C4 and C5 (strides 8, 16, 32;
512, 1024 and 2048 channels), what the FPN reads.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..batchnorm import BatchNorm2d
from ..layers import Conv2d
from .dla import DCN, DCNSpec

BLOCKS = (3, 4, 23, 3)
WIDTHS = (64, 128, 256, 512)
STAGE_WITH_DCN = (False, False, True, True)
EXPANSION = 4
BN_EPS = 1e-5


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS)


class Bottleneck(nn.Module):
    """1x1 (strided) -> 3x3 or DCN -> 1x1, each with BN, the sum ReLU'd."""

    def __init__(self, cin: int, planes: int, stride: int, dcn: Optional[DCNSpec]):
        super().__init__()
        cout = planes * EXPANSION
        self.conv1 = Conv2d(cin, planes, 1, stride, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = (DCN(planes, planes, dcn) if dcn is not None
                      else Conv2d(planes, planes, 3, 1, padding=1, bias=False))
        self.bn2 = _bn(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False)
        self.bn3 = _bn(cout)
        self.downsample = (nn.Sequential(Conv2d(cin, cout, 1, stride, bias=False), _bn(cout))
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        shortcut = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + shortcut)


class ResNetCaffe(nn.Module):
    """Stem and four stages of ``BLOCKS`` bottlenecks; the stages flagged in
    ``STAGE_WITH_DCN`` run ``spec``'s DCN in every bottleneck."""

    out_channels = tuple(w * EXPANSION for w in WIDTHS[1:])    # C3, C4, C5

    def __init__(self, spec: DCNSpec):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = _bn(64)
        cin = 64
        for i, (n, planes, dcn) in enumerate(zip(BLOCKS, WIDTHS, STAGE_WITH_DCN)):
            stride = 1 if i == 0 else 2
            layer = []
            for b in range(n):
                layer.append(Bottleneck(cin, planes, stride if b == 0 else 1,
                                        spec if dcn else None))
                cin = planes * EXPANSION
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return [c3, c4, self.layer4(c4)]
