"""Detector shell: on-device normalize -> backbone -> predictor (counterpart of
``monoflex_tpu/models/detector.py``).

Input images are NHWC as in the JAX package: uint8 is normalized here
(/255, optional BGR flip, mean/std), anything else is taken as already
normalized.  The NHWC tensor is viewed as NCHW without a copy, which makes
every activation channels-last: the layout the DCN kernel reads (C
contiguous per pixel) and the one cuDNN prefers.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .precision import apply_precision, resolve_precision
from .dla import DCN, BilinearUp, build_backbone
from .predictor import Predictor, build_predictor


class MonoFlex(nn.Module):
    """KeypointDetector equivalent; returns the raw head maps (NCHW)."""

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

    def forward(self, images: torch.Tensor, edge_indices: Optional[torch.Tensor] = None,
                edge_len: Optional[torch.Tensor] = None) -> Dict[str, object]:
        if images.dtype == torch.uint8:
            x = images.float() / 255.0
            if self.to_bgr:
                x = x.flip(-1)
            images = (x - self.pixel_mean) / self.pixel_std
        features = self.backbone(images.permute(0, 3, 1, 2))
        return self.heads["predictor"](features, edge_indices, edge_len)


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
        if isinstance(m, (DCN, BilinearUp, Predictor, MonoFlex)):
            m.reset_parameters(generator)


def build_model(cfg, device="cuda", seed: int = 0, use_dcn_kernel: bool = True) -> MonoFlex:
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU), in eval mode, channels-last, with weights from ``seed``.
    ``use_dcn_kernel=False`` runs the plain DCN op where the config names the
    kernel (the kernel's reference).  It sets torch's matmul/convolution
    precision flags from ``cfg`` (``utils/precision.py``) and keeps them as
    ``model.precision``, which the train and eval steps apply again."""
    precision = apply_precision(resolve_precision(cfg))
    with torch.device("meta"):
        backbone = build_backbone(cfg, use_dcn_kernel)
        model = MonoFlex(backbone, build_predictor(cfg, in_channels=backbone.out_channels),
                         pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
                         pixel_std=tuple(cfg.INPUT.PIXEL_STD),
                         to_bgr=bool(cfg.INPUT.TO_BGR))
    model = model.to_empty(device=device)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.precision = precision
    return model.to(memory_format=torch.channels_last).eval()
