"""The feature pyramid of FCOS3D (mmdetection's ``FPN(start_level=1,
add_extra_convs="on_output", num_outs=5, relu_before_extra_convs=True)``).

From the trunk's C3, C4 and C5: 1x1 laterals to ``CHANNELS``, a top-down
pass that adds each coarser lateral, nearest-upsampled to the finer map's
size, then a 3x3 output conv on each; P6 is a 3x3/2 conv on P5's output and
P7 a 3x3/2 conv on ReLU(P6).  Every conv has a bias and no norm.  It runs in
the model's compute dtype (``models/layers.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d

CHANNELS = 256


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], extra: int = 2):
        super().__init__()
        channels = CHANNELS
        self.lateral_convs = nn.ModuleList(Conv2d(c, channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(Conv2d(channels, channels, 3, padding=1)
                                       for _ in in_channels)
        self.extra_convs = nn.ModuleList(Conv2d(channels, channels, 3, 2, padding=1)
                                         for _ in range(extra))
        self.out_channels = channels

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[-2:], mode="nearest")
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        for i, conv in enumerate(self.extra_convs):
            outs.append(conv(outs[-1] if i == 0 else torch.relu(outs[-1])))
        return outs
