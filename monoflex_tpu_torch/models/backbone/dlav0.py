"""The vanilla DLA family ("dlav0"): plain-conv aggregation over deep trunks
(counterpart of ``monoflex_tpu/models/backbone/dlav0.py``).

The pre-DCN DLA of early CenterNet (reference: model/backbone/dlav0.py): the
trunk of ``dla.py`` with a BasicBlock, Bottleneck or BottleneckX residual
block, and an upsampling neck whose projection is a 1x1 conv-BN-ReLU, whose
node is a 3x3 conv-BN-ReLU over the concatenation of two maps, and whose
upsampling is the bilinear-initialised depthwise transposed conv.  No
deformable convolution: every op is a cuDNN convolution, and the family
launches no kernel of the port.  ``CONV_BODY`` "dlav0" is the vanilla
DLA-34, "dlav0_<name>" a deeper trunk of ``DLAV0_FAMILY``.  Torch names
follow the reference's modules (``proj_i``/``node_i`` as conv, BN, ReLU
sequences, ``up_i``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from .dla import DLA, BilinearUp, _conv_bn_relu

# name -> (levels, channels, block, residual_root, cardinality)
# (reference: model/backbone/dlav0.py:320-412; the Bottleneck's expansion is
# 2 in every constructor there)
DLAV0_FAMILY = {
    "dla34": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 128, 256, 512), "basic", False, 32),
    "dla46_c": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 64, 128, 256), "bottleneck", False, 32),
    "dla46x_c": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 64, 128, 256), "bottleneckx", False, 32),
    "dla60x_c": ((1, 1, 1, 2, 3, 1), (16, 32, 64, 64, 128, 256), "bottleneckx", False, 32),
    "dla60": ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024), "bottleneck", False, 32),
    "dla60x": ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024), "bottleneckx", False, 32),
    "dla102": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024), "bottleneck", True, 32),
    "dla102x": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024), "bottleneckx", True, 32),
    "dla102x2": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024), "bottleneckx", True, 64),
    "dla169": ((1, 1, 2, 3, 5, 1), (16, 32, 128, 256, 512, 1024), "bottleneck", True, 32),
}


def vanilla_trunk(body: str) -> str:
    """The DLAV0_FAMILY name of CONV_BODY "dlav0" (dla34) or "dlav0_<name>"."""
    return body[len("dlav0_"):] if body.startswith("dlav0_") else "dla34"


class VanillaIDAUp(nn.Module):
    """Plain-conv iterative deep aggregation (reference:
    model/backbone/dlav0.py:440-496): each input whose width is not
    ``out_dim`` is projected by a 1x1 conv-BN-ReLU and upsampled, then the
    maps merge left to right through 3x3 node convs over the concatenation.
    Returns the last merged map and every merge's output."""

    def __init__(self, out_dim: int, in_channels: Sequence[int], up_factors: Sequence[int]):
        super().__init__()
        self.n = len(in_channels)
        for i, (cin, f) in enumerate(zip(in_channels, up_factors)):
            if cin != out_dim:
                setattr(self, f"proj_{i}", nn.Sequential(*_conv_bn_relu(cin, out_dim, 1)))
            if f > 1:
                setattr(self, f"up_{i}", BilinearUp(out_dim, int(f)))
        for i in range(1, self.n):
            setattr(self, f"node_{i}", nn.Sequential(*_conv_bn_relu(2 * out_dim, out_dim, 3)))

    def forward(self, layers: List[torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        layers = list(layers)
        for i in range(self.n):
            for name in (f"proj_{i}", f"up_{i}"):
                if hasattr(self, name):
                    layers[i] = getattr(self, name)(layers[i])
        x, merged = layers[0], []
        for i in range(1, self.n):
            x = getattr(self, f"node_{i}")(torch.cat([x, layers[i]], dim=1))
            merged.append(x)
        return x, merged


class VanillaDLAUp(nn.Module):
    """Pyramid aggregation of the vanilla family (reference:
    model/backbone/dlav0.py:499-521): merge the deepest remaining levels
    upward, the merge outputs taking the place of the pyramid's tail."""

    def __init__(self, channels: Sequence[int], scales: Sequence[int]):
        super().__init__()
        channels = list(channels)
        in_channels = list(channels)
        scales = list(scales)
        self.n = len(channels) - 1
        for i in range(self.n):
            j = -i - 2
            setattr(self, f"ida_{i}", VanillaIDAUp(channels[j], in_channels[j:],
                                                   [s // scales[j] for s in scales[j:]]))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_channels[j + 1:] = [channels[j]] * len(in_channels[j + 1:])

    def forward(self, layers: List[torch.Tensor]) -> torch.Tensor:
        layers = list(layers)
        x = layers[-1]
        for i in range(self.n):
            x, merged = getattr(self, f"ida_{i}")(layers[-i - 2:])
            layers[-i - 1:] = merged
        return x


class DLAV0Seg(nn.Module):
    """Deep-block DLA trunk -> plain-conv DLAUp -> one stride-``down_ratio``
    map of ``channels[log2(down_ratio)]`` features (reference:
    model/backbone/dlav0.py:534-585, without its heads)."""

    def __init__(self, base_name: str = "dla34", down_ratio: int = 4):
        super().__init__()
        if base_name not in DLAV0_FAMILY:
            raise NotImplementedError(f"dlav0 trunk {base_name!r}: one of {sorted(DLAV0_FAMILY)}")
        levels, channels, block, residual_root, cardinality = DLAV0_FAMILY[base_name]
        self.first_level = int(math.log2(down_ratio))
        self.out_channels = channels[self.first_level]
        self.base = DLA(channels, levels, block, residual_root, cardinality)
        ch = list(channels[self.first_level:])
        self.dla_up = VanillaDLAUp(ch, [2 ** i for i in range(len(ch))])

    def forward(self, x) -> torch.Tensor:
        return self.dla_up(self.base(x)[self.first_level:])
