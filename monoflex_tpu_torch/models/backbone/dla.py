"""DLA trunk and the DCN iterative-deep-aggregation neck (counterpart of
``monoflex_tpu/models/backbone/dla.py``).

NCHW modules with OIHW weights, named as in the reference torch model so a
state dict maps one to one onto the JAX parameter tree
(``utils/param_bridge.py``).  The trunk is the plain stem: the JAX package's
packed stem is a TPU relayout with the same math and the same parameters.
Its residual block is the DLA-34 ``BasicBlock`` or, for the deeper trunks of
the vanilla family (``dlav0.py``), ``Bottleneck`` or ``BottleneckX``, with an
optional residual root.  Every projection and node of the neck is a 3x3
modulated DCNv2 whose offsets are clamped to +-R; on a CUDA tensor it runs
the Hopper kernel.  The "gather" impl is the unbounded DCN (the plain op,
with no clamp, on the CPU and the card alike) and "none" a plain 3x3 conv
(``dla34_nodcn``).  Under TPU.DCN_FUSE_BN_RELU an eval-mode block folds its
BN and ReLU into the kernel's output write.  "shift" is the port of the JAX
package's XLA clamped op (``ops/dcn.py::modulated_deform_conv_shift``), which
under a bf16 model weighs and sums its window in bf16.

Under ``TPU.COMPUTE_DTYPE`` "bfloat16" the trunk and the neck run in bf16
where the JAX package runs them so (its ``dtype``; ``models/layers.py``):
the convolutions, the BNs' outputs, the residual sums and the transposed
convolutions.  A DCN's offset/mask conv runs in bf16 and is cast to f32
before the split, so its offsets are bf16 values; a kernel impl takes x as
it is (bf16) and returns f32, which the BN casts back; the gather and
"shift" return x's dtype.  The parameters stay f32.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.dcn import (modulated_deform_conv, modulated_deform_conv_bn_relu,
                        modulated_deform_conv_shift)
from ...ops.dcn_cuda import dcn_forward, dcn_forward_bn_relu
from ...utils.precision import compute_dtype
from ..batchnorm import BatchNorm2d, recomputing
from ..layers import Conv2d, set_compute_dtype

BN_EPS = 1e-5


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS)


def _conv_bn_relu(cin: int, cout: int, kernel: int, stride: int = 1) -> List[nn.Module]:
    return [Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=False),
            _bn(cout), nn.ReLU(inplace=True)]


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, padding=1, bias=False)
        self.bn1 = _bn(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, padding=1, bias=False)
        self.bn2 = _bn(cout)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        out = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(out)) + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 residual bottleneck, expansion 2
    (reference: model/backbone/dlav0.py:59-97); ``groups`` > 1 is
    ``BottleneckX``'s grouped 3x3."""

    def __init__(self, cin: int, cout: int, stride: int = 1, mid: int = 0, groups: int = 1):
        super().__init__()
        mid = mid or cout // 2
        self.conv1 = Conv2d(cin, mid, 1, bias=False)
        self.bn1 = _bn(mid)
        self.conv2 = Conv2d(mid, mid, 3, stride, padding=1, groups=groups, bias=False)
        self.bn2 = _bn(mid)
        self.conv3 = Conv2d(mid, cout, 1, bias=False)
        self.bn3 = _bn(cout)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        return torch.relu(self.bn3(self.conv3(out)) + residual)


class BottleneckX(Bottleneck):
    """ResNeXt-style grouped bottleneck (reference:
    model/backbone/dlav0.py:100-141): width cout * cardinality / 32, the 3x3
    in ``cardinality`` groups."""

    def __init__(self, cin: int, cout: int, stride: int = 1, cardinality: int = 32):
        super().__init__(cin, cout, stride, mid=cout * cardinality // 32, groups=cardinality)


def make_block(block: str, cin: int, cout: int, stride: int, cardinality: int) -> nn.Module:
    if block == "basic":
        return BasicBlock(cin, cout, stride)
    if block == "bottleneck":
        return Bottleneck(cin, cout, stride)
    if block == "bottleneckx":
        return BottleneckX(cin, cout, stride, cardinality)
    raise ValueError(f"unknown DLA block {block!r}")


class Root(nn.Module):
    def __init__(self, cin: int, cout: int, residual: bool = False):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, bias=False)
        self.bn = _bn(cout)
        self.residual = residual

    def forward(self, children: List[torch.Tensor]):
        x = self.bn(self.conv(torch.cat(children, dim=1)))
        return torch.relu(x + children[0] if self.residual else x)


class Tree(nn.Module):
    def __init__(self, levels: int, cin: int, cout: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0, root_residual: bool = False,
                 block: str = "basic", cardinality: int = 32):
        super().__init__()
        root_dim = root_dim or 2 * cout
        if level_root:
            root_dim += cin
        kind = dict(root_residual=root_residual, block=block, cardinality=cardinality)
        if levels == 1:
            self.tree1 = make_block(block, cin, cout, stride, cardinality)
            self.tree2 = make_block(block, cout, cout, 1, cardinality)
            self.root = Root(root_dim, cout, root_residual)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride, **kind)
            self.tree2 = Tree(levels - 1, cout, cout, root_dim=root_dim + cout, **kind)
        self.levels = levels
        self.level_root = level_root
        # VALID max-pool, as flax's max_pool and the reference's MaxPool2d
        self.downsample = nn.MaxPool2d(stride, stride) if stride > 1 else None
        self.project = (nn.Sequential(Conv2d(cin, cout, 1, bias=False), _bn(cout))
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
CHANNELS = (16, 32, 64, 128, 256, 512)


def _conv_level(cin: int, cout: int, convs: int, stride: int = 1) -> nn.Sequential:
    """``convs`` 3x3 conv-BN-ReLUs, the first strided (slots 3i, 3i+1, 3i+2)."""
    layers: List[nn.Module] = []
    for i in range(convs):
        layers += _conv_bn_relu(cin if i == 0 else cout, cout, 3, stride if i == 0 else 1)
    return nn.Sequential(*layers)


class DLA(nn.Module):
    """The trunk: a 7x7 stem, two plain conv levels, then four aggregation
    trees; ``levels``, ``channels``, the residual ``block``, the residual root
    and the cardinality select a member of the family (DLA-34 by default)."""

    compute_dtype = torch.float32

    def __init__(self, channels: Sequence[int] = CHANNELS, levels: Sequence[int] = LEVELS,
                 block: str = "basic", residual_root: bool = False, cardinality: int = 32):
        super().__init__()
        ch = channels
        self.base_layer = nn.Sequential(*_conv_bn_relu(3, ch[0], 7))
        self.level0 = _conv_level(ch[0], ch[0], levels[0])
        self.level1 = _conv_level(ch[0], ch[1], levels[1], stride=2)
        for lv in range(2, 6):
            setattr(self, f"level{lv}", Tree(levels[lv], ch[lv - 1], ch[lv], 2,
                                             level_root=lv != 2, root_residual=residual_root,
                                             block=block, cardinality=cardinality))

    def forward(self, x) -> List[torch.Tensor]:
        x = x.to(self.compute_dtype)
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
    """How one neck stage runs its DCNs: the offset clamp R (None: the
    unbounded "gather" op), the dtype x is rounded to before sampling,
    whether CUDA tensors go through the Hopper kernels (True) or the plain
    PyTorch op (False, the kernels' reference), whether an eval-mode block
    fuses its BN and ReLU into the DCN's output write, and the impl's name
    ("none": a plain 3x3 conv in place of the DCN)."""

    max_offset: Optional[int]
    transfer_dtype: torch.dtype
    use_kernel: bool
    fuse_bn_relu: bool = False
    impl: str = ""


class DCN(nn.Module):
    """3x3 modulated deformable conv whose offsets and mask come from a
    regular conv on the same input (reference: DCNv2's DCN module).  With the
    kernels it runs ``dcn_forward``, whose backward is the kernels' too."""

    def __init__(self, cin: int, cout: int, spec: DCNSpec):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.conv_offset_mask = Conv2d(cin, 27, 3, padding=1, bias=True)
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
        with the bias already folded into shift.  f32 out, or x's dtype under
        the unbounded op and "shift"."""
        # in the compute dtype, then f32 before the split, as the JAX DCN
        om = self.conv_offset_mask(x).float().permute(0, 2, 3, 1)   # (B,H,W,27)
        # channels 0-17 are the interleaved offsets, 18-26 the mask logits
        offset = om[..., :18].contiguous()
        mask = torch.sigmoid(om[..., 18:]).contiguous()
        args = (x.permute(0, 2, 3, 1).contiguous(), offset, mask,
                self.weight.permute(2, 3, 1, 0).contiguous())
        kw = dict(max_offset=self.spec.max_offset, transfer_dtype=self.spec.transfer_dtype)
        if epilogue is not None:
            op = dcn_forward_bn_relu if self.spec.use_kernel else modulated_deform_conv_bn_relu
            y = op(*args, *epilogue, **kw)
        elif self.spec.impl == "shift":
            y = modulated_deform_conv_shift(*args, self.bias, max_offset=self.spec.max_offset)
        else:
            op = dcn_forward if self.spec.use_kernel else modulated_deform_conv
            y = op(*args, self.bias, **kw)
        return y.permute(0, 3, 1, 2)


class DeformConvBlock(nn.Module):
    """DCN -> BN -> ReLU (reference: DeformConv in dla_dcn.py); under impl
    "none" a plain 3x3 conv with bias takes the DCN's place (the JAX block's
    ``Conv_0``).

    With ``spec.fuse_bn_relu``, eval mode folds the BN (running stats) and
    the DCN's bias into the kernel's epilogue, as the JAX block does under
    TPU.DCN_FUSE_BN_RELU: a = gamma * rsqrt(var + eps),
    b = beta - mean * a + bias * a.  The state dict is the same either way,
    and train mode always runs the real BN."""

    def __init__(self, cin: int, cout: int, spec: DCNSpec):
        super().__init__()
        self.conv = (Conv2d(cin, cout, 3, padding=1, bias=True) if spec.impl == "none"
                     else DCN(cin, cout, spec))
        self.actf = nn.Sequential(_bn(cout), nn.ReLU(inplace=True))

    def forward(self, x):
        bn = self.actf[0]
        if self.training or not isinstance(self.conv, DCN) or not self.conv.spec.fuse_bn_relu:
            return self.actf(self.conv(x))
        a = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        b = bn.bias - bn.running_mean * a + self.conv.bias * a
        return self.conv(x, epilogue=(a, b)).to(bn.compute_dtype)


class BilinearUp(nn.ConvTranspose2d):
    """Depthwise transposed conv, kernel 2f, stride f, pad f/2, bilinear
    initialised.  Its weight is the JAX kernel transposed, not flipped: the
    JAX module flips its kernel to emulate the transposed conv.

    Two forms of one function, as the JAX module's ``impl``: "dilated" (the
    default) is ``F.conv_transpose2d``; "phase" is the phase decomposition,
    in which output pixel (f*m + a, f*n + b) takes exactly two taps per axis,
    so each of the f*f phases is a per-channel weighted sum of 4 shifted
    copies of x, and the phases are interleaved
    (``tools/bilinear_ablate.py`` times the two)."""

    IMPLS = ("dilated", "phase")

    def __init__(self, channels: int, factor: int, impl: str = "dilated"):
        if impl not in self.IMPLS:
            raise ValueError(f"BilinearUp impl {impl!r}: one of {self.IMPLS}")
        super().__init__(channels, channels, 2 * factor, stride=factor,
                         padding=factor // 2, groups=channels, bias=False)
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "phase":
            return self._phase(x)
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        # the JAX module casts its kernel to x's dtype
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)

    def _phase(self, x: torch.Tensor) -> torch.Tensor:
        # out[y] = sum_i x[i] * w[y + p - f*i] with 0 <= y + p - f*i < 2f: for
        # y = f*m + a the taps are r_a and r_a + f, r_a = (a + p) % f, on the
        # sources m + e_a and m + e_a - 1, e_a = (a + p) // f
        f, p = self.stride[0], self.padding[0]
        B, C, H, W = x.shape
        k = self.weight.to(x.dtype)[:, 0, :, :, None, None]       # (C, 2f, 2f, 1, 1)
        xpad = F.pad(x, (1, 1, 1, 1))

        def sh(dy: int, dx: int) -> torch.Tensor:
            return xpad[:, :, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

        phases = []
        for a in range(f):
            ra, ea = (a + p) % f, (a + p) // f
            for b in range(f):
                rb, eb = (b + p) % f, (b + p) // f
                phases.append(k[:, ra, rb] * sh(ea, eb) + k[:, ra, rb + f] * sh(ea, eb - 1)
                              + k[:, ra + f, rb] * sh(ea - 1, eb)
                              + k[:, ra + f, rb + f] * sh(ea - 1, eb - 1))
        out = torch.stack(phases).view(f, f, B, C, H, W)
        return out.permute(2, 3, 4, 0, 5, 1).reshape(B, C, f * H, f * W)

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
    one DCNSpec per neck stage (ida_0 deepest, ida_1, ida_2, final ida_up).
    ``remat`` (``TPU.REMAT_BACKBONE``) recomputes the trunk in the backward
    (``torch.utils.checkpoint``), as the JAX trunk runs under ``nn.remat``;
    the recomputation leaves the BN running stats alone.
    ``use_dcn_kernel``: whether the specs put the kernel impls on the
    kernels (``resolve_dcn_specs``), which a reroute keeps."""

    last_level = 5

    def __init__(self, specs: Sequence[DCNSpec], down_ratio: int = 4,
                 channels: Sequence[int] = CHANNELS, remat: bool = False,
                 use_dcn_kernel: bool = True):
        super().__init__()
        self.remat = remat
        self.use_dcn_kernel = use_dcn_kernel
        self.first_level = int(math.log2(down_ratio))
        last_level = self.last_level
        ch = list(channels[self.first_level:])
        if len(specs) != len(ch):
            raise ValueError(f"need {len(ch)} DCN stage specs, got {len(specs)}")
        self.out_channels = channels[self.first_level]
        self.base = DLA(channels)
        self.dla_up = DLAUp(ch, [2 ** i for i in range(len(ch))], specs[:-1])
        n_final = last_level - self.first_level
        self.ida_up = IDAUp(channels[self.first_level], channels[self.first_level:last_level],
                            [2 ** i for i in range(n_final)], specs[-1])

    def forward(self, x) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            feats = checkpoint(self.base, x, use_reentrant=False,
                               context_fn=lambda: (nullcontext(), recomputing(self.base)))
        else:
            feats = self.base(x)
        pyramid = self.dla_up(feats[self.first_level:])
        return self.ida_up(pyramid[:self.last_level - self.first_level])[-1]

    def stages(self) -> List[IDAUp]:
        """The neck's stages in DCNSpec order: ida_0, ida_1, ida_2, ida_up."""
        return [getattr(self.dla_up, f"ida_{i}") for i in range(self.dla_up.n)] + [self.ida_up]


N_DCN_STAGES = 4  # ida_0 (deepest merge), ida_1, ida_2, final ida_up

# DCN impl name -> (transfer dtype, Hopper kernel).  "pallas3b" is the TPU
# main path (x shipped in bf16, f32 math); "shift" is the XLA clamped op.
# The v1 ("pallas") and v2 ("pallas2", "pallas2p") generations are TPU
# stagings of the same function with float32 x (pallas2p lane-packs C=Co=64
# layers; v1/v2 split the dmask+dW and doffset backward), so they run the
# Hopper kernels with float32 transfer.  "gather" is the JAX package's
# unbounded XLA op, here the plain op with no clamp (no kernel, on the card
# too); "none" a plain 3x3 conv.
_IMPLS = {
    "pallas3b": (torch.bfloat16, True),
    "pallas3": (torch.float32, True),
    "pallas2p": (torch.float32, True),
    "pallas2": (torch.float32, True),
    "pallas": (torch.float32, True),
    "shift": (torch.float32, False),
    "gather": (torch.float32, False),
    "none": (torch.float32, False),
}
# the impls that clamp the offsets to +-R (the offset guard's "bounded")
BOUNDED_IMPLS = frozenset(k for k in _IMPLS if k not in ("gather", "none"))
# impls whose eval-mode block takes the fused BN+ReLU epilogue under
# TPU.DCN_FUSE_BN_RELU (the JAX model fuses only into its v3 kernel)
_FUSABLE = ("pallas3b", "pallas3")
# TPU.DCN_DX_KERNEL values: three TPU stagings of one dx function, all
# served by the one kernel dcn_bwd_dx
DX_KERNELS = ("dx3", "dx4", "dx5")


def is_vanilla(body: str) -> bool:
    """The vanilla (no-DCN) family: "dlav0" and "dlav0_<name>"."""
    return body == "dlav0" or body.startswith("dlav0_")


def resolve_dcn_stages(cfg) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The (impls, max_offsets) of the 4 neck stages, as the JAX package's
    ``resolve_dcn_stages`` resolves them: "none" under ``dla34_nodcn`` and
    the dlav0 family, else DCN_FORCE_IMPL or the automatic choice, which is
    the TPU's (pallas3b; DCN_KERNEL_VERSION 1 and 2 through their impls;
    "shift" without USE_PALLAS_DCN); DCN_IMPL_PER_STAGE overrides both."""
    body = cfg.MODEL.BACKBONE.CONV_BODY
    impl = "none" if body == "dla34_nodcn" or is_vanilla(body) else _auto_impl(cfg)
    impls = tuple(cfg.TPU.DCN_IMPL_PER_STAGE) or (impl,) * N_DCN_STAGES
    rs = tuple(cfg.TPU.DCN_MAX_OFFSET_PER_STAGE) or (cfg.TPU.DCN_MAX_OFFSET,) * N_DCN_STAGES
    return impls, rs


def _auto_impl(cfg) -> str:
    """DCN_FORCE_IMPL, or the TPU's automatic choice (pallas3b; DCN_KERNEL_VERSION
    1 and 2 through their impls; "shift" without USE_PALLAS_DCN)."""
    return cfg.TPU.DCN_FORCE_IMPL or (
        {1: "pallas", 2: "pallas2", 3: "pallas3b"}[cfg.TPU.DCN_KERNEL_VERSION]
        if cfg.TPU.USE_PALLAS_DCN else "shift")


def _spec(cfg, impl: str, r, use_kernel: bool, fusable: bool) -> DCNSpec:
    if impl not in _IMPLS:
        raise NotImplementedError(f"DCN impl {impl!r} is not ported; served: {sorted(_IMPLS)}")
    dtype, kernel = _IMPLS[impl]
    return DCNSpec(int(r) if impl in BOUNDED_IMPLS else None, dtype, kernel and use_kernel,
                   fusable and bool(cfg.TPU.DCN_FUSE_BN_RELU) and impl in _FUSABLE, impl)


def _check_dx_kernel(cfg) -> None:
    if cfg.TPU.DCN_DX_KERNEL not in DX_KERNELS:
        raise ValueError(f"TPU.DCN_DX_KERNEL {cfg.TPU.DCN_DX_KERNEL!r}: one of {DX_KERNELS}")


def resolve_dcn_specs(cfg, use_kernel: bool = True) -> Tuple[DCNSpec, ...]:
    """The DCNSpec of each neck stage (``resolve_dcn_stages``).
    ``use_kernel=False`` runs the plain op wherever the config names the
    kernel (fused or not)."""
    _check_dx_kernel(cfg)
    return tuple(_spec(cfg, impl, r, use_kernel, fusable=True)
                 for impl, r in zip(*resolve_dcn_stages(cfg)))


def resolve_dcn_spec(cfg, use_kernel: bool = True) -> DCNSpec:
    """The one DCNSpec of a model whose DCNs all take one route (FCOS3D's
    trunk and head): DCN_FORCE_IMPL or the automatic choice, clamped at
    DCN_MAX_OFFSET, never fused (no fused epilogue serves a DCN followed by
    a GroupNorm or inside a bottleneck).  The per-stage keys are the DLA
    neck's and raise here."""
    _check_dx_kernel(cfg)
    if tuple(cfg.TPU.DCN_IMPL_PER_STAGE) or tuple(cfg.TPU.DCN_MAX_OFFSET_PER_STAGE):
        raise ValueError("TPU.DCN_IMPL_PER_STAGE and DCN_MAX_OFFSET_PER_STAGE route the DLA "
                         "neck's stages; a model without that neck takes one route")
    impl = _auto_impl(cfg)
    if impl == "none":
        raise NotImplementedError("DCN impl 'none' is the DLA neck's plain-conv variant")
    return _spec(cfg, impl, cfg.TPU.DCN_MAX_OFFSET, use_kernel, fusable=False)


def set_dcn_specs(backbone: DLASeg, specs: Sequence[DCNSpec]) -> None:
    """Route each neck stage of ``backbone`` by ``specs`` in place.  The
    parameters stay as they are, so a DCN impl may change for another but
    not for "none" or from it (those have other parameters)."""
    for stage, spec in zip(backbone.stages(), specs):
        for m in stage.modules():
            if isinstance(m, DCN):
                if spec.impl == "none":
                    raise ValueError("a DCN stage cannot be rerouted to impl 'none'")
                m.spec = spec


def build_backbone(cfg, use_dcn_kernel: bool = True) -> nn.Module:
    """The backbone of ``MODEL.BACKBONE.CONV_BODY``: "dla34" (the DCN neck),
    "dla34_nodcn" (its topology on plain convs), "dlav0" or "dlav0_<name>"
    (the vanilla family, ``dlav0.py``), or "R-101" (FCOS3D's caffe ResNet-101
    with DCNv2 bottlenecks, ``resnet.py``), in ``TPU.COMPUTE_DTYPE``."""
    body = cfg.MODEL.BACKBONE.CONV_BODY
    dtype = compute_dtype(cfg)
    if is_vanilla(body):
        from .dlav0 import DLAV0Seg, vanilla_trunk

        # the JAX family has no remat: TPU.REMAT_BACKBONE does not reach it
        backbone = DLAV0Seg(vanilla_trunk(body), down_ratio=cfg.MODEL.BACKBONE.DOWN_RATIO)
    elif body in ("dla34", "dla34_nodcn"):
        backbone = DLASeg(resolve_dcn_specs(cfg, use_dcn_kernel),
                          down_ratio=cfg.MODEL.BACKBONE.DOWN_RATIO,
                          remat=bool(cfg.TPU.REMAT_BACKBONE), use_dcn_kernel=use_dcn_kernel)
    elif body == "R-101":
        from .resnet import ResNetCaffe

        backbone = ResNetCaffe(resolve_dcn_spec(cfg, use_dcn_kernel))
    else:
        raise NotImplementedError(f"backbone {body!r}: one of 'dla34', 'dla34_nodcn', "
                                  f"'dlav0', 'dlav0_<name>', 'R-101'")
    set_compute_dtype(backbone, dtype)
    return backbone
