"""BatchNorm with flax's train-mode statistics.

The JAX package's BatchNorm is ``flax.linen.BatchNorm(momentum=0.9)``.  In
train mode it normalizes with the batch mean and the biased batch variance,
as torch does, but it also folds the *biased* variance into the running
variance, where torch folds the unbiased one (a factor n/(n-1) apart, 6% on a
16-pixel map).  The JAX package is the reference, so these modules follow
flax: running_mean and running_var move 0.1 of the way to the batch mean and
biased variance.  Eval mode is stock torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class _FlaxStats:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=[0, *range(2, x.dim())], correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class BatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass
