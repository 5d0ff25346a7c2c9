"""Layers that run in a compute dtype, as flax's ``dtype=`` attribute runs them.

The JAX package builds its trunk, neck and head towers with ``dtype`` set to
``TPU.COMPUTE_DTYPE`` while their parameters stay f32.  These modules carry
that dtype as ``compute_dtype`` (float32 unless ``set_compute_dtype`` says
otherwise), with flax's semantics:

- ``Conv2d``: input and kernel cast to the compute dtype (cuDNN accumulates
  a bf16 convolution in f32 and rounds its output to bf16), and the bias
  added after the convolution, in the compute dtype, as ``flax.linen.Conv``
  adds it;
- ``GroupNorm``: flax's ``GroupNorm`` (epsilon 1e-6, not torch's 1e-5,
  unless the caller gives one), its statistics and normalisation in f32,
  its output cast once to the compute dtype;
- the BatchNorms of ``models/batchnorm.py`` and the modules of
  ``models/backbone`` that cast (the trunk's input, the transposed
  convolution's kernel) read the same attribute.

At float32 each is the stock torch module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6    # flax.linen.GroupNorm's default epsilon
GN_GROUPS = 32


class Conv2d(nn.Conv2d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32 and x.dtype == dt:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt).view(1, -1, 1, 1)


class GroupNorm(nn.GroupNorm):
    compute_dtype = torch.float32

    def __init__(self, channels: int, eps: float = GN_EPS):
        super().__init__(GN_GROUPS, channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Set the compute dtype of every submodule of ``module`` that has one."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype


class Linear(nn.Linear):
    """A dense layer in ``compute_dtype``: input, kernel and bias cast to it
    (a bf16 product accumulates in f32 and rounds its output to bf16)."""
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with its statistics and normalisation in f32, its output
    cast once to ``compute_dtype``."""
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)
