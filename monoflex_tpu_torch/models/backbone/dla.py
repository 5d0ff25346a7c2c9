"""DLA-34 trunk and the DCN iterative-deep-aggregation neck (counterpart of
``monoflex_tpu/models/backbone/dla.py``).

NCHW modules with OIHW weights, named as in the reference torch model so a
state dict maps one to one onto the JAX parameter tree
(``utils/param_bridge.py``).  The trunk is the plain stem: the JAX package's
packed stem is a TPU relayout with the same math and the same parameters.
Every projection and node of the neck is a 3x3 modulated DCNv2 whose offsets
are clamped to +-R; on a CUDA tensor it runs the Hopper kernel.  Under
TPU.DCN_FUSE_BN_RELU an eval-mode block folds its BN and ReLU into the
kernel's output write.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.dcn import modulated_deform_conv, modulated_deform_conv_bn_relu
from ...ops.dcn_cuda import dcn_forward, dcn_forward_bn_relu
from ..batchnorm import BatchNorm2d

BN_EPS = 1e-5


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS)


def _conv_bn_relu(cin: int, cout: int, kernel: int, stride: int = 1) -> List[nn.Module]:
    return [nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=False),
            _bn(cout), nn.ReLU(inplace=True)]


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, padding=1, bias=False)
        self.bn1 = _bn(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, padding=1, bias=False)
        self.bn2 = _bn(cout)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        out = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(out)) + residual)


class Root(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = _bn(cout)

    def forward(self, children: List[torch.Tensor]):
        return torch.relu(self.bn(self.conv(torch.cat(children, dim=1))))


class Tree(nn.Module):
    def __init__(self, levels: int, cin: int, cout: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0):
        super().__init__()
        root_dim = root_dim or 2 * cout
        if level_root:
            root_dim += cin
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride)
            self.tree2 = BasicBlock(cout, cout, 1)
            self.root = Root(root_dim, cout)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride)
            self.tree2 = Tree(levels - 1, cout, cout, root_dim=root_dim + cout)
        self.levels = levels
        self.level_root = level_root
        # VALID max-pool, as flax's max_pool and the reference's MaxPool2d
        self.downsample = nn.MaxPool2d(stride, stride) if stride > 1 else None
        self.project = (nn.Sequential(nn.Conv2d(cin, cout, 1, bias=False), _bn(cout))
                        if cin != cout else None)

    def forward(self, x, children: Optional[List[torch.Tensor]] = None):
        children = [] if children is None else children
        bottom = self.downsample(x) if self.downsample is not None else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.project(bottom) if self.project is not None else bottom
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        # a deeper tree's own projection feeds nothing: tree1 projects again.
        # In train mode the JAX tree still runs it, which folds the batch
        # statistics into its BN's running stats; so does this one.
        if self.training and self.project is not None:
            with torch.no_grad():
                self.project(bottom)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


# DLA-34: one conv at levels 0 and 1, then trees of depth 1, 2, 2, 1
LEVELS = (1, 1, 1, 2, 2, 1)


class DLA(nn.Module):
    def __init__(self, channels: Sequence[int] = (16, 32, 64, 128, 256, 512)):
        super().__init__()
        ch = channels
        self.base_layer = nn.Sequential(*_conv_bn_relu(3, ch[0], 7))
        self.level0 = nn.Sequential(*_conv_bn_relu(ch[0], ch[0], 3))
        self.level1 = nn.Sequential(*_conv_bn_relu(ch[0], ch[1], 3, stride=2))
        for lv in range(2, 6):
            setattr(self, f"level{lv}", Tree(LEVELS[lv], ch[lv - 1], ch[lv], 2,
                                             level_root=lv != 2))

    def forward(self, x) -> List[torch.Tensor]:
        y = self.level0(self.base_layer(x))
        outputs = [y]
        y = self.level1(y)
        outputs.append(y)
        for lv in range(2, 6):
            y = getattr(self, f"level{lv}")(y)
            outputs.append(y)
        return outputs


@dataclass(frozen=True)
class DCNSpec:
    """How one neck stage runs its DCNs: the offset clamp R, the dtype x is
    rounded to before sampling, whether CUDA tensors go through the Hopper
    kernels (True) or the plain PyTorch op (False, the kernels' reference),
    and whether an eval-mode block fuses its BN and ReLU into the DCN's
    output write."""

    max_offset: int
    transfer_dtype: torch.dtype
    use_kernel: bool
    fuse_bn_relu: bool = False


class DCN(nn.Module):
    """3x3 modulated deformable conv whose offsets and mask come from a
    regular conv on the same input (reference: DCNv2's DCN module).  With the
    kernels it runs ``dcn_forward``, whose backward is the kernels' too."""

    def __init__(self, cin: int, cout: int, spec: DCNSpec):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.conv_offset_mask = nn.Conv2d(cin, 27, 3, padding=1, bias=True)
        self.spec = spec

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """uniform(-s, s), s = 1/sqrt(fan_in), bias 0; the offset/mask conv
        starts at zero (no deformation, mask 0.5)."""
        s = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.copy_((torch.rand(self.weight.shape, generator=generator) * 2 - 1) * s)
        self.bias.zero_()
        self.conv_offset_mask.weight.zero_()
        self.conv_offset_mask.bias.zero_()

    def forward(self, x, epilogue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """The DCN of x (NCHW); with ``epilogue`` (scale, shift) it returns
        relu(DCN(x; no bias) * scale + shift) instead, the fused eval BN+ReLU
        with the bias already folded into shift."""
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)   # (B,H,W,27)
        # channels 0-17 are the interleaved offsets, 18-26 the mask logits
        offset = om[..., :18].contiguous()
        mask = torch.sigmoid(om[..., 18:]).contiguous()
        args = (x.permute(0, 2, 3, 1).contiguous(), offset, mask,
                self.weight.permute(2, 3, 1, 0).contiguous())
        kw = dict(max_offset=self.spec.max_offset, transfer_dtype=self.spec.transfer_dtype)
        if epilogue is not None:
            op = dcn_forward_bn_relu if self.spec.use_kernel else modulated_deform_conv_bn_relu
            y = op(*args, *epilogue, **kw)
        else:
            op = dcn_forward if self.spec.use_kernel else modulated_deform_conv
            y = op(*args, self.bias, **kw)
        return y.permute(0, 3, 1, 2)


class DeformConvBlock(nn.Module):
    """DCN -> BN -> ReLU (reference: DeformConv in dla_dcn.py).

    With ``spec.fuse_bn_relu``, eval mode folds the BN (running stats) and
    the DCN's bias into the kernel's epilogue, as the JAX block does under
    TPU.DCN_FUSE_BN_RELU: a = gamma * rsqrt(var + eps),
    b = beta - mean * a + bias * a.  The state dict is the same either way,
    and train mode always runs the real BN."""

    def __init__(self, cin: int, cout: int, spec: DCNSpec):
        super().__init__()
        self.conv = DCN(cin, cout, spec)
        self.actf = nn.Sequential(_bn(cout), nn.ReLU(inplace=True))

    def forward(self, x):
        if self.training or not self.conv.spec.fuse_bn_relu:
            return self.actf(self.conv(x))
        bn = self.actf[0]
        a = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        b = bn.bias - bn.running_mean * a + self.conv.bias * a
        return self.conv(x, epilogue=(a, b))


class BilinearUp(nn.ConvTranspose2d):
    """Depthwise transposed conv, kernel 2f, stride f, pad f/2, bilinear
    initialised.  Its weight is the JAX kernel transposed, not flipped: the
    JAX module flips its kernel to emulate the transposed conv."""

    def __init__(self, channels: int, factor: int):
        super().__init__(channels, channels, 2 * factor, stride=factor,
                         padding=factor // 2, groups=channels, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        kh = self.weight.shape[2]
        f = math.ceil(kh / 2)
        center = (2 * f - 1 - f % 2) / (2.0 * f)
        r = 1 - (torch.arange(kh, dtype=torch.float32) / f - center).abs()
        self.weight.copy_((r[:, None] * r[None, :]).expand_as(self.weight))


class IDAUp(nn.Module):
    """Iterative deep aggregation over a pyramid slice."""

    def __init__(self, cout: int, in_channels: Sequence[int], up_factors: Sequence[int],
                 spec: DCNSpec):
        super().__init__()
        self.n = len(in_channels)
        for i in range(1, self.n):
            f = int(up_factors[i])
            setattr(self, f"proj_{i}", DeformConvBlock(in_channels[i], cout, spec))
            setattr(self, f"up_{i}", BilinearUp(cout, f) if f > 1 else nn.Identity())
            setattr(self, f"node_{i}", DeformConvBlock(cout, cout, spec))

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        for i in range(1, self.n):
            up = getattr(self, f"up_{i}")(getattr(self, f"proj_{i}")(layers[i]))
            layers[i] = getattr(self, f"node_{i}")(up + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """Repeatedly merge the deepest levels upward; ``specs`` holds one
    DCNSpec per ida stage, deepest first."""

    def __init__(self, channels: Sequence[int], scales: Sequence[int],
                 specs: Sequence[DCNSpec]):
        super().__init__()
        channels = list(channels)
        in_channels = list(channels)
        scales = list(scales)
        self.n = len(channels) - 1
        for i in range(self.n):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(channels[j], in_channels[j:],
                                            [s // scales[j] for s in scales[j:]], specs[i]))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_channels[j + 1:] = [channels[j]] * len(in_channels[j + 1:])

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.n):
            j = -i - 2
            layers[j:] = getattr(self, f"ida_{i}")(layers[j:])
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """DLA trunk -> DLAUp -> final IDAUp -> one stride-4 map.  ``specs``:
    one DCNSpec per neck stage (ida_0 deepest, ida_1, ida_2, final ida_up)."""

    last_level = 5

    def __init__(self, specs: Sequence[DCNSpec], down_ratio: int = 4,
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512)):
        super().__init__()
        self.first_level = int(math.log2(down_ratio))
        last_level = self.last_level
        ch = list(channels[self.first_level:])
        if len(specs) != len(ch):
            raise ValueError(f"need {len(ch)} DCN stage specs, got {len(specs)}")
        self.base = DLA(channels)
        self.dla_up = DLAUp(ch, [2 ** i for i in range(len(ch))], specs[:-1])
        n_final = last_level - self.first_level
        self.ida_up = IDAUp(channels[self.first_level], channels[self.first_level:last_level],
                            [2 ** i for i in range(n_final)], specs[-1])

    def forward(self, x) -> torch.Tensor:
        pyramid = self.dla_up(self.base(x)[self.first_level:])
        return self.ida_up(pyramid[:self.last_level - self.first_level])[-1]


N_DCN_STAGES = 4  # ida_0 (deepest merge), ida_1, ida_2, final ida_up

# DCN impl name -> (transfer dtype, Hopper kernel).  "pallas3b" is the TPU
# main path (x shipped in bf16, f32 math); "shift" is the XLA clamped op.
# The v1 ("pallas") and v2 ("pallas2", "pallas2p") generations are TPU
# stagings of the same function with float32 x (pallas2p lane-packs C=Co=64
# layers; v1/v2 split the dmask+dW and doffset backward), so they run the
# Hopper kernels with float32 transfer.
_IMPLS = {
    "pallas3b": (torch.bfloat16, True),
    "pallas3": (torch.float32, True),
    "pallas2p": (torch.float32, True),
    "pallas2": (torch.float32, True),
    "pallas": (torch.float32, True),
    "shift": (torch.float32, False),
}
# impls whose eval-mode block takes the fused BN+ReLU epilogue under
# TPU.DCN_FUSE_BN_RELU (the JAX model fuses only into its v3 kernel)
_FUSABLE = ("pallas3b", "pallas3")
# TPU.DCN_DX_KERNEL values: three TPU stagings of one dx function, all
# served by the one kernel dcn_bwd_dx
DX_KERNELS = ("dx3", "dx4", "dx5")


def resolve_dcn_specs(cfg, use_kernel: bool = True) -> Tuple[DCNSpec, ...]:
    """The DCNSpec of each neck stage, resolved from the config as the JAX
    package resolves its impls (``resolve_dcn_stages``), with the TPU's
    automatic choice (pallas3b) as the default, and DCN_KERNEL_VERSION 1 and
    2 through their impls.  ``use_kernel=False`` runs the plain op wherever
    the config names the kernel (fused or not)."""
    if cfg.TPU.DCN_DX_KERNEL not in DX_KERNELS:
        raise ValueError(f"TPU.DCN_DX_KERNEL {cfg.TPU.DCN_DX_KERNEL!r}: one of {DX_KERNELS}")
    auto = ({1: "pallas", 2: "pallas2", 3: "pallas3b"}[cfg.TPU.DCN_KERNEL_VERSION]
            if cfg.TPU.USE_PALLAS_DCN else "shift")
    impls = tuple(cfg.TPU.DCN_IMPL_PER_STAGE) or (cfg.TPU.DCN_FORCE_IMPL or auto,) * N_DCN_STAGES
    rs = tuple(cfg.TPU.DCN_MAX_OFFSET_PER_STAGE) or (cfg.TPU.DCN_MAX_OFFSET,) * N_DCN_STAGES
    specs = []
    for impl, r in zip(impls, rs):
        if impl not in _IMPLS:
            raise NotImplementedError(
                f"DCN impl {impl!r} is not ported; served: {sorted(_IMPLS)}")
        dtype, kernel = _IMPLS[impl]
        specs.append(DCNSpec(int(r), dtype, kernel and use_kernel,
                             bool(cfg.TPU.DCN_FUSE_BN_RELU) and impl in _FUSABLE))
    return tuple(specs)


def build_backbone(cfg, use_dcn_kernel: bool = True) -> DLASeg:
    body = cfg.MODEL.BACKBONE.CONV_BODY
    if body != "dla34":
        raise NotImplementedError(f"backbone {body!r} is not ported; served: 'dla34'")
    if cfg.TPU.COMPUTE_DTYPE != "float32":
        raise NotImplementedError(f"TPU.COMPUTE_DTYPE {cfg.TPU.COMPUTE_DTYPE!r}: only float32")
    return DLASeg(resolve_dcn_specs(cfg, use_dcn_kernel),
                  down_ratio=cfg.MODEL.BACKBONE.DOWN_RATIO)
