"""Optimizer, LR schedules and parameter EMA (counterpart of
``monoflex_tpu/train/solver.py``).

The JAX package chains optax transforms; here one ``Optimizer`` applies the
same chain around a torch optimizer, in the same order:

1. clip the global gradient norm over every parameter (``GRAD_NORM_CLIP``);
2. AdamW (decoupled decay), Adam (decay coupled into the gradient, as an L2
   term), SGD with momentum 0.9 (coupled decay), or AdamW with b1 cycled
   inversely to the LR (``adam_onecycle``); betas (0.9, 0.99);
3. the LR from the schedule at the optimizer's own count of applied updates
   (optax's count), times ``BIAS_LR_FACTOR`` for every parameter named
   ``*.bias`` (BN beta included: flax names it ``bias`` too) and
   ``BACKBONE_LR_FACTOR`` for every ``backbone.*`` parameter;
4. ``FREEZE_CONV_BODY_AT`` > 0 leaves the trunk (``backbone.base.*``) out of
   the update altogether, weight decay included;
5. the parameter EMA with the bias-corrected decay min(decay, (1+n)/(10+n)).
   As in the JAX package it does not shadow the BN running stats.

A step that is not taken (the train step's non-finite guard) moves none of
it: not the count, the schedule, the moments nor the EMA.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

Schedule = Callable[[int], float]


def multi_step_schedule(base_lr: float, decay_steps: Sequence[int], decay: float,
                        lr_clip: float, warmup_steps: int = 0,
                        warmup_div: float = 10.0) -> Schedule:
    """LR(step): base * decay^(milestones passed), floored at lr_clip; with a
    cosine warm-up from base / warmup_div over the first ``warmup_steps``."""
    decay_steps = list(decay_steps)

    def schedule(step: int) -> float:
        factor = 1.0
        for s in decay_steps:
            factor *= decay if step >= s else 1.0
        if step < warmup_steps:
            eta_min = base_lr / warmup_div
            return eta_min + (base_lr - eta_min) * 0.5 * (
                1 + math.cos(math.pi * step / warmup_steps + math.pi))
        return max(base_lr * factor, lr_clip)

    return schedule


def _cos_interp(a: float, b: float, t: float) -> float:
    """t = 0 -> a, t = 1 -> b along a half cosine."""
    return b + (a - b) * 0.5 * (1 + math.cos(math.pi * t))


def _one_cycle(total_steps: int, pct_start: float, up_from: float, peak: float,
               down_to: float) -> Schedule:
    up = max(1, int(total_steps * pct_start))
    down = max(1, total_steps - up)

    def schedule(step: int) -> float:
        if step < up:
            return _cos_interp(up_from, peak, min(max(step / up, 0.0), 1.0))
        return _cos_interp(peak, down_to, min(max((step - up) / down, 0.0), 1.0))

    return schedule


def one_cycle_schedule(base_lr: float, total_steps: int, div_factor: float = 10.0,
                       pct_start: float = 0.4) -> Schedule:
    """Cosine one-cycle: base/div -> base over pct_start of the steps, then
    down to base / (div * 1e4)."""
    return _one_cycle(total_steps, pct_start, base_lr / div_factor, base_lr,
                      base_lr / (div_factor * 1e4))


def one_cycle_momentum(total_steps: int, moms: Sequence[float] = (0.95, 0.85),
                       pct_start: float = 0.4) -> Schedule:
    """b1 inverse to the one-cycle LR: moms[0] -> moms[1] while the LR
    rises, back to moms[0] after."""
    return _one_cycle(total_steps, pct_start, float(moms[0]), float(moms[1]), float(moms[0]))


class ParamEma:
    """Exponential moving average of the parameters (not the BN stats)."""

    def __init__(self, model: nn.Module, decay: float):
        self.decay = decay
        self.shadow = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.count = 0

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        self.count += 1
        d = min(self.decay, (1.0 + self.count) / (10.0 + self.count))
        for name, p in model.named_parameters():
            self.shadow[name].mul_(d).add_(p, alpha=1.0 - d)


class Optimizer:
    """A torch optimizer driven as the JAX package's optax chain (see the
    module docstring).  ``count`` is the number of updates applied."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Schedule,
                 params: List[nn.Parameter], grad_clip: float = 0.0,
                 momentum: Optional[Schedule] = None, ema: Optional[ParamEma] = None,
                 model: Optional[nn.Module] = None):
        self.inner = inner
        self.schedule = schedule
        self.params = params
        self.grad_clip = grad_clip
        self.momentum = momentum
        self.ema = ema
        self.model = model
        self.count = 0

    @torch.no_grad()
    def _clip(self) -> None:
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        for g in grads:
            g.mul_(scale)

    def step(self) -> None:
        """One update from the gradients in ``.grad``.  A parameter the loss
        does not reach gets a zero gradient, as JAX gives it, so weight decay
        and the moments still move it."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip > 0:
            self._clip()
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr * group["lr_factor"]
            if self.momentum is not None:
                group["betas"] = (self.momentum(self.count), group["betas"][1])
        self.inner.step()
        self.count += 1
        if self.ema is not None:
            self.ema.update(self.model)


def lr_factors(name: str, cfg) -> Tuple[bool, float]:
    """(trained, LR factor) of the parameter ``name`` under ``cfg``."""
    s = cfg.SOLVER
    if cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT > 0 and name.startswith("backbone.base."):
        return False, 0.0
    factor = s.BIAS_LR_FACTOR if name.rsplit(".", 1)[-1] == "bias" else 1.0
    if name.startswith("backbone."):
        factor *= s.BACKBONE_LR_FACTOR
    return True, factor


def build_optimizer(cfg, model: nn.Module, steps_per_epoch: int = 1
                    ) -> Tuple[Optimizer, Schedule, Optional[ParamEma]]:
    """(optimizer, LR schedule, parameter EMA or None) for ``model`` under
    ``cfg.SOLVER``; decay milestones given in epochs are converted with
    ``steps_per_epoch``."""
    s = cfg.SOLVER
    if s.EVAL_AND_SAVE_EPOCH:
        decay_iters = [e * steps_per_epoch for e in s.DECAY_EPOCH_STEPS]
        warmup = s.WARMUP_EPOCH * steps_per_epoch if s.LR_WARMUP else 0
    else:
        decay_iters = list(s.STEPS)
        warmup = s.WARMUP_STEPS if s.LR_WARMUP else 0

    name = s.OPTIMIZER
    momentum = None
    if name == "adam_onecycle":
        schedule = one_cycle_schedule(s.BASE_LR, s.MAX_ITERATION, s.DIV_FACTOR, s.PCT_START)
        momentum = one_cycle_momentum(s.MAX_ITERATION, s.MOMS, s.PCT_START)
    else:
        schedule = multi_step_schedule(s.BASE_LR, decay_iters, s.LR_DECAY, s.LR_CLIP, warmup,
                                       s.DIV_FACTOR)

    groups: Dict[float, List[nn.Parameter]] = {}
    params = []
    for pname, p in model.named_parameters():
        params.append(p)
        trained, factor = lr_factors(pname, cfg)
        if trained:
            groups.setdefault(factor, []).append(p)
    lr0 = schedule(0)
    param_groups = [{"params": ps, "lr_factor": f, "lr": lr0 * f} for f, ps in groups.items()]
    wd = s.WEIGHT_DECAY
    if name in ("adamw", "adam_onecycle"):
        b1 = momentum(0) if momentum is not None else 0.9
        inner = torch.optim.AdamW(param_groups, betas=(b1, 0.99), eps=1e-8, weight_decay=wd)
    elif name == "adam":
        inner = torch.optim.Adam(param_groups, betas=(0.9, 0.99), eps=1e-8, weight_decay=wd)
    elif name == "sgd":
        inner = torch.optim.SGD(param_groups, momentum=0.9, weight_decay=wd)
    else:
        raise NotImplementedError(name)

    ema = ParamEma(model, s.EMA_DECAY) if getattr(s, "EMA_DECAY", 0.0) > 0.0 else None
    opt = Optimizer(inner, schedule, params, grad_clip=max(0.0, float(s.GRAD_NORM_CLIP)),
                    momentum=momentum, ema=ema, model=model)
    return opt, schedule, ema
