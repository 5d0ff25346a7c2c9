"""Detector shells: on-device normalize -> backbone -> predictor (counterpart of
``monoflex_tpu/models/detector.py``), FCOS3D (``FCOSMono3D``: normalize
and pad -> caffe ResNet -> FPN -> the five-level head) and BEVFormer
(``bevformer.py``: the same trunk and an FPN to P6 under a spatiotemporal
BEV transformer), which the JAX package does not have.
``MODEL.META_ARCHITECTURE`` chooses one.

Input images are NHWC as in the JAX package: uint8 is normalized here
(/255, optional BGR flip, mean/std), anything else is taken as already
normalized.  The NHWC tensor is viewed as NCHW without a copy, which makes
every activation channels-last: the layout the DCN kernel reads (C
contiguous per pixel) and the one cuDNN prefers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..utils.precision import apply_precision, compute_dtype, resolve_precision
from . import bevformer
from .backbone.dla import DCN, BilinearUp, build_backbone, resolve_dcn_spec
from .backbone.resnet import ResNetCaffe
from .fpn import FPN
from .heads.fcos3d import STRIDES, FCOS3DHead
from .heads.predictor import Predictor, build_predictor
from .layers import set_compute_dtype

META_ARCHITECTURES = ("MonoFlex", "FCOSMono3D", "BEVFormer")
RESNET_ARCHITECTURES = ("FCOSMono3D", "BEVFormer")


def normalize(images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
              to_bgr: bool) -> torch.Tensor:
    """uint8 NHWC images to (x / 255 [flipped to BGR] - mean) / std;
    anything else as it is."""
    if images.dtype != torch.uint8:
        return images
    x = images.float() / 255.0
    if to_bgr:
        x = x.flip(-1)
    return (x - mean) / std


class MonoFlex(nn.Module):
    """KeypointDetector equivalent; returns the raw head maps (NCHW)."""

    arch = "MonoFlex"     # its MODEL.META_ARCHITECTURE

    def __init__(self, backbone: nn.Module, predictor: Predictor,
                 pixel_mean: Sequence[float] = (0.485, 0.456, 0.406),
                 pixel_std: Sequence[float] = (0.229, 0.224, 0.225), to_bgr: bool = False):
        super().__init__()
        self.backbone = backbone
        self.heads = nn.ModuleDict({"predictor": predictor})
        self.mean_std = (tuple(pixel_mean), tuple(pixel_std))
        # not in the state dict: they come from the config, not a checkpoint
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std), persistent=False)
        self.to_bgr = to_bgr

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.pixel_mean.copy_(torch.tensor(self.mean_std[0]))
        self.pixel_std.copy_(torch.tensor(self.mean_std[1]))

    def graph_inputs(self, batch: Dict[str, torch.Tensor]) -> Tuple[Optional[torch.Tensor], ...]:
        """The forward's inputs from an evaluation batch."""
        return batch["image"], batch.get("edge_indices"), batch.get("edge_len")

    def forward(self, images: torch.Tensor, edge_indices: Optional[torch.Tensor] = None,
                edge_len: Optional[torch.Tensor] = None) -> Dict[str, object]:
        images = normalize(images, self.pixel_mean, self.pixel_std, self.to_bgr)
        features = self.backbone(images.permute(0, 3, 1, 2))
        return self.heads["predictor"](features, edge_indices, edge_len)


class FCOSMono3D(MonoFlex):
    """FCOS3D: the normalized image zero-padded at the bottom and right to a
    multiple of ``size_divisor``, the trunk's C3-C5, the FPN's P3-P7, the
    head.  Returns one f32 map a level (``heads/fcos3d.py::fields``); the
    edge inputs of the MonoFlex signature are taken and not read."""

    arch = "FCOSMono3D"

    def __init__(self, backbone: nn.Module, fpn: FPN, head: FCOS3DHead, size_divisor: int,
                 **normalize_kw):
        super().__init__(backbone, head, **normalize_kw)
        self.fpn = fpn
        self.size_divisor = size_divisor

    def forward(self, images: torch.Tensor, edge_indices: Optional[torch.Tensor] = None,
                edge_len: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        x = normalize(images, self.pixel_mean, self.pixel_std, self.to_bgr)
        d = self.size_divisor
        if d > 1:
            H, W = x.shape[1:3]
            x = torch.nn.functional.pad(x, (0, 0, 0, -W % d, 0, -H % d))
        return self.heads["predictor"](self.fpn(self.backbone(x.permute(0, 3, 1, 2))))


def require_trainable(arch: str) -> None:
    """Raise unless the training entry points can train the meta-architecture
    ``arch`` (the config's ``MODEL.META_ARCHITECTURE``)."""
    if arch == "BEVFormer":
        raise NotImplementedError(
            "MODEL.META_ARCHITECTURE 'BEVFormer' runs on the evaluation path only "
            "(build_model, make_eval_step): its training (a queue of history frames run "
            "without gradients, Hungarian matching, focal and L1 losses, a backward of the "
            "multi-scale deformable attention, dcn_bwd_dwmo at 512 channels) is not ported "
            "(ROADMAP F11)")
    if arch != "MonoFlex":
        raise NotImplementedError(
            f"MODEL.META_ARCHITECTURE {arch!r} runs on the evaluation path only "
            f"(build_model, make_eval_step): its training (target assignment over the FPN "
            f"levels, its losses) is not ported")


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every parameter and buffer, drawn on the CPU from
    ``generator`` so a seed gives the same weights on any device: convs
    lecun-normal with zero bias (flax's default), BatchNorm identity, then
    the module-specific inits (DCN, bilinear upsampling, head priors)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in model.modules():
        if isinstance(m, (DCN, BilinearUp, Predictor, FCOS3DHead, MonoFlex)):
            m.reset_parameters(generator)


def build_model(cfg, device="cuda", seed: int = 0, use_dcn_kernel: bool = True) -> MonoFlex:
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU), in eval mode, channels-last, with weights from ``seed``.
    ``use_dcn_kernel=False`` runs the plain DCN op where the config names the
    kernel (the kernel's reference).  It sets torch's matmul/convolution
    precision flags from ``cfg`` (``utils/precision.py``) and keeps them as
    ``model.precision``, which the train and eval steps apply again."""
    precision = apply_precision(resolve_precision(cfg))
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch not in META_ARCHITECTURES:
        raise NotImplementedError(f"MODEL.META_ARCHITECTURE {arch!r}: one of {META_ARCHITECTURES}")
    normalize_kw = dict(pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
                        pixel_std=tuple(cfg.INPUT.PIXEL_STD), to_bgr=bool(cfg.INPUT.TO_BGR))
    with torch.device("meta"):
        backbone = build_backbone(cfg, use_dcn_kernel)
        if isinstance(backbone, ResNetCaffe) != (arch in RESNET_ARCHITECTURES):
            raise NotImplementedError(
                f"MODEL.META_ARCHITECTURE {arch!r} does not take MODEL.BACKBONE.CONV_BODY "
                f"{cfg.MODEL.BACKBONE.CONV_BODY!r}: FCOSMono3D and BEVFormer take the ResNets, "
                f"MonoFlex the DLA trunks")
        if arch == "MonoFlex":
            model = MonoFlex(backbone, build_predictor(cfg, in_channels=backbone.out_channels),
                             **normalize_kw)
        elif arch == "FCOSMono3D":
            model = _fcos3d(cfg, backbone, use_dcn_kernel, normalize_kw)
        else:
            model = _bevformer(cfg, backbone, normalize_kw)
    model = model.to_empty(device=device)
    if arch == "BEVFormer":
        bevformer.init_weights(model, seed)
    else:
        init_parameters(model, torch.Generator().manual_seed(seed))
    model.precision = precision
    return model.to(memory_format=torch.channels_last).eval()


def _fcos3d(cfg, backbone: nn.Module, use_dcn_kernel: bool, normalize_kw: Dict) -> FCOSMono3D:
    """FCOS3D of ``cfg`` on its trunk (``MODEL.BACKBONE.CONV_BODY`` "R-101");
    the FPN and the head's towers and branches in the compute dtype."""
    fpn = FPN(backbone.out_channels, extra=len(STRIDES) - len(backbone.out_channels))
    head = FCOS3DHead(fpn.out_channels, resolve_dcn_spec(cfg, use_dcn_kernel))
    dtype = compute_dtype(cfg)
    for m in [fpn, *head.towers()]:
        set_compute_dtype(m, dtype)
    return FCOSMono3D(backbone, fpn, head, int(cfg.DATALOADER.SIZE_DIVISIBILITY), **normalize_kw)


def _bevformer(cfg, backbone: nn.Module, normalize_kw: Dict) -> bevformer.BEVFormer:
    """BEVFormer-base on ``cfg``'s trunk (``MODEL.BACKBONE.CONV_BODY``
    "R-101"): the FPN to P6 and the transformer in the compute dtype."""
    fpn = FPN(backbone.out_channels, extra=1)
    model = bevformer.BEVFormer(backbone, fpn, int(cfg.DATALOADER.SIZE_DIVISIBILITY),
                                **normalize_kw)
    model.set_compute_dtype(compute_dtype(cfg))
    return model
