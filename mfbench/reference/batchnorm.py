"""BatchNorm with flax's train-mode statistics, over the global batch.

The JAX package's BatchNorm is ``flax.linen.BatchNorm(momentum=0.9)``.  In
train mode it normalizes with the batch mean and the biased batch variance,
as torch does, but it also folds the *biased* variance into the running
variance, where torch folds the unbiased one (a factor n/(n-1) apart, 6% on a
16-pixel map).  The JAX package is the reference, so these modules follow
flax: running_mean and running_var move 0.1 of the way to the batch mean and
biased variance.  Eval mode is stock torch.

Under data parallelism the JAX step is one function of the global batch, so
with more than one process the train-mode mean and variance are those of
every process's samples together: the sums are reduced with
``torch.distributed.nn.functional.all_reduce``, whose backward reduces the
gradient too, in two passes (the mean, then the centred squares; E[x^2] -
E[x]^2 loses digits in f32 on the trunk's 1-pixel maps).
``torch.nn.SyncBatchNorm`` does not serve: it folds the unbiased variance
and takes no CPU tensors.

Under ``TPU.REMAT_BACKBONE`` the trunk's forward runs again in the backward
(``recomputing``); the running stats move once a step, in the first run.

Under a bf16 model (``compute_dtype`` bfloat16, set by ``build_model``)
the module follows flax's ``BatchNorm(dtype=bfloat16)`` (flax
``normalization.py`` ``_compute_stats`` and ``_normalize``): the statistics
are reduced in f32 whatever the input's dtype (a bf16 input's mean and
E[x^2] accumulate in f32 without an f32 copy, and var = E[x^2] - mean^2, as
flax's fast variance), (x - mean) * rsqrt(var + eps) * scale + bias is
computed in f32 (scale and bias are f32), and the output is cast once, to
bf16.  The input may be bf16 (a trunk conv) or f32 (a DCN's output).  The
parameters and the running statistics stay f32.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn

from . import comm


class _FlaxStats:
    recomputing = False
    compute_dtype = torch.float32    # the output's dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # F.batch_norm takes a bf16 input with f32 parameters and statistics,
        # computes in f32 and writes bf16
        return self._normalize(x).to(self.compute_dtype)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0, *range(2, x.dim())]
        if comm.get_world_size() == 1:
            with torch.no_grad():
                if x.dtype == torch.float32:
                    var, mean = torch.var_mean(x, dim=dims, correction=0)
                else:
                    n = x.numel() / x.shape[1]
                    mean = x.sum(dims, dtype=torch.float32) / n
                    sq = torch.linalg.vector_norm(x, 2, dims, dtype=torch.float32) ** 2 / n
                    var = (sq - mean * mean).clamp_min(0.0)
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        else:
            y, mean, var = self._global_batch_norm(x.float(), dims)
        if not self.recomputing:
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
                self.num_batches_tracked.add_(1)
        return y

    def _global_batch_norm(self, x: torch.Tensor, dims):
        from torch.distributed.nn.functional import all_reduce

        shape = [1, -1] + [1] * (x.dim() - 2)
        sums = all_reduce(torch.cat([x.sum(dims), x.new_full((1,), x.numel() / x.shape[1])]))
        count = sums[-1].detach()
        mean = sums[:-1] / count
        centred = x - mean.view(shape)
        var = all_reduce((centred * centred).sum(dims)) / count
        y = centred * torch.rsqrt(var + self.eps).view(shape)
        return y * self.weight.view(shape) + self.bias.view(shape), mean, var


class BatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


@contextmanager
def recomputing(module: nn.Module) -> Iterator[None]:
    """Mark every flax-statistics BN under ``module`` as running a
    recomputation, which leaves the running stats alone."""
    bns = [m for m in module.modules() if isinstance(m, _FlaxStats)]
    for m in bns:
        m.recomputing = True
    try:
        yield
    finally:
        for m in bns:
            m.recomputing = False
