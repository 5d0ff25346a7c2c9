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
   ``ema_params`` swaps it into the model for an evaluation or a save.

``state_dict`` of the optimizer and the EMA holds tensors and plain values
only, for ``train/checkpoint.py``; the schedules are rebuilt from the config
and read at the restored count.  Build both on the unwrapped model, so their
parameter names carry no ``module.`` prefix from DistributedDataParallel.

A step that is not taken (the train step's non-finite guard) moves none of
it: not the count, the schedule, the moments nor the EMA.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

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

    def state_dict(self) -> Dict[str, object]:
        return {"shadow": dict(self.shadow), "count": self.count}

    def check_state_dict(self, state: Dict[str, object]) -> None:
        """Raise ValueError unless ``state`` shadows exactly these parameters."""
        if sorted(state["shadow"]) != sorted(self.shadow):
            raise ValueError("the EMA shadows other parameters than the checkpoint's")

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.check_state_dict(state)
        for name, value in state["shadow"].items():
            self.shadow[name].copy_(value)
        self.count = int(state["count"])


@contextmanager
def ema_params(model: nn.Module, ema: Optional[ParamEma]) -> Iterator[nn.Module]:
    """``model`` with the EMA shadow in its parameters for the body of the
    ``with`` (counterpart of the JAX package's ``get_ema_params``); the raw
    parameters come back bit for bit on exit.  The BN running stats are not
    shadowed (C6).  Without an EMA the model is left as it is."""
    if ema is None:
        yield model
        return
    params = dict(model.named_parameters())
    raw = {n: p.detach().clone() for n, p in params.items()}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(ema.shadow[n])
    try:
        yield model
    finally:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(raw[n])


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

    def prepare_gradients(self) -> None:
        """The gradients as the update takes them: a parameter the loss does
        not reach gets a zero gradient, as JAX gives it, so weight decay and
        the moments still move it; then the clip."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip > 0:
            self._clip()

    def step(self) -> None:
        """One update from the gradients in ``.grad``."""
        self.prepare_gradients()
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr * group["lr_factor"]
            if self.momentum is not None:
                group["betas"] = (self.momentum(self.count), group["betas"][1])
        self.inner.step()
        self.count += 1
        if self.ema is not None:
            self.ema.update(self.model)

    def state_dict(self) -> Dict[str, object]:
        """The moments, the count of applied updates (the schedule and the
        one-cycle momentum are functions of it) and the EMA."""
        return {"inner": self.inner.state_dict(), "count": self.count,
                "ema": None if self.ema is None else self.ema.state_dict()}

    @torch.no_grad()
    def load_named_state(self, moments: Dict[str, Dict[str, torch.Tensor]], count: int,
                         ema: Optional[Dict[str, torch.Tensor]], ema_count: int) -> None:
        """Restore Adam's moments by parameter name ({"exp_avg": {name:
        tensor}, "exp_avg_sq": {...}}, torch layouts; a converted JAX
        checkpoint's), the update count and the EMA; ValueError, with nothing
        changed, when the optimizer, the parameters or the EMA differ."""
        if self.model is None:
            raise ValueError("the optimizer has no model to name its parameters")
        names = {id(p): n for n, p in self.model.named_parameters()}
        if not isinstance(self.inner, (torch.optim.Adam, torch.optim.AdamW)):
            raise ValueError("converted moments are Adam's: the optimizer is "
                             f"{type(self.inner).__name__}")
        ours = [names[id(p)] for g in self.inner.param_groups for p in g["params"]]
        if any(n not in m for m in moments.values() for n in ours):
            raise ValueError("the checkpoint's moments lack some of the optimizer's parameters")
        if (ema is None) != (self.ema is None):
            raise ValueError("EMA on one side only (SOLVER.EMA_DECAY differs)")
        if self.ema is not None:
            self.ema.check_state_dict({"shadow": ema})
        for group in self.inner.param_groups:
            for p in group["params"]:
                self.inner.state[p] = {
                    "step": torch.tensor(float(count)),
                    **{k: moments[k][names[id(p)]].to(p.device, p.dtype).clone()
                       for k in ("exp_avg", "exp_avg_sq")}}
        self.count = count
        if self.ema is not None:
            self.ema.load_state_dict({"shadow": ema, "count": ema_count})

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restore ``state_dict()``; ValueError, with nothing changed, when
        its structure differs (EMA on one side only, other parameters or
        parameter groups)."""
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError("EMA on one side only (SOLVER.EMA_DECAY differs)")
        if self.ema is not None:
            self.ema.check_state_dict(state["ema"])
        groups = state["inner"]["param_groups"]
        if [len(g["params"]) for g in groups] != [len(g["params"])
                                                  for g in self.inner.param_groups]:
            raise ValueError("the checkpoint's parameter groups differ")
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        if self.ema is not None:
            self.ema.load_state_dict(state["ema"])


# the values of a parameter group in ``DeviceUpdate.values``, in this order:
# AdamW's decay factor 1 - lr wd, the first moment's lerp weight 1 - beta1,
# sqrt(1 - beta2^t) and the step size -lr / (1 - beta1^t); the EMA's decay d
# and 1 - d follow the groups
_DECAY, _LERP, _BC2, _STEP = range(4)
_PER_GROUP = 4


def device_update_refusal(opt: Optimizer) -> Optional[str]:
    """Why ``DeviceUpdate`` cannot take ``opt``'s step, or None: it mirrors
    the stock ``Optimizer.step`` around torch's foreach Adam and AdamW."""
    if "step" in vars(opt) or type(opt).step is not Optimizer.step:
        return "its step is replaced"
    inner = opt.inner
    if type(inner) not in (torch.optim.Adam, torch.optim.AdamW):
        return f"{type(inner).__name__} has no device update (Adam and AdamW have)"
    for group in inner.param_groups:
        for flag in ("amsgrad", "maximize", "capturable", "differentiable", "fused"):
            if group.get(flag):
                return f"{flag}=True"
        if group.get("foreach") is False:
            return "foreach=False"
        if any(p.dtype != torch.float32 or p.device.type != "cuda" for p in group["params"]):
            return "a parameter is not float32 on the card"
    return None


class _Group:
    """One parameter group's tensors and the settings a graph bakes in."""

    def __init__(self, inner: torch.optim.Optimizer, group: dict, momentum: bool):
        self.group = group
        self.params = list(group["params"])
        states = [inner.state[p] for p in self.params]
        self.exp_avgs = [s["exp_avg"] for s in states]
        self.exp_avg_sqs = [s["exp_avg_sq"] for s in states]
        self.steps = [s["step"] for s in states]
        if len({float(t) for t in self.steps}) != 1:
            raise ValueError("the group's parameters have taken different numbers of steps")
        self.beta1 = None if momentum else group["betas"][0]
        self.beta2, self.eps = group["betas"][1], group["eps"]
        self.weight_decay = group["weight_decay"]
        self.decoupled = group.get("decoupled_weight_decay",
                                   isinstance(inner, torch.optim.AdamW))


class DeviceUpdate:
    """``Optimizer.step`` after ``prepare_gradients`` as device ops a CUDA
    graph can hold (``train/train_graph.py``).  ``apply`` launches the ops of
    torch's foreach Adam(W) and of ``ParamEma.update``, with the same
    arithmetic, but every value that changes from step to step (a group's
    LR, the schedule at ``count`` times its factor; one-cycle's beta1;
    Adam's bias corrections; the EMA's decay) is read from ``values``, a
    device tensor that ``write`` fills before each replay, never baked into
    the graph.  A product with such a value runs as ``mul_``, ``lerp_`` or
    ``addcmul_`` with a 0-dim device tensor, which rounds as the op with a
    Python scalar does (the same fused multiply-adds; bit for bit in
    ``tests/test_torch_train_graph.py``).  The host's counters (``count``,
    each parameter's Adam ``step``, the groups' ``lr`` and ``betas``, the
    EMA's count) move in ``commit``, once the step is known to be taken.

    Built outside the capture, for an optimizer ``device_update_refusal``
    accepts, with moments for every parameter it updates (after one step);
    ``write`` reuses one pinned buffer, so a step's values must have reached
    the card (the caller's read of the step's flag) before the next write."""

    def __init__(self, opt: Optimizer):
        reason = device_update_refusal(opt)
        if reason is not None:
            raise ValueError(f"no device update for this optimizer: {reason}")
        self.opt = opt
        inner = opt.inner
        self.groups = [_Group(inner, g, opt.momentum is not None)
                       for g in inner.param_groups if g["params"]]
        if not self.groups:
            raise ValueError("no parameter to update")
        self.steps = [t for g in self.groups for t in g.steps]
        self.ema_pairs: List[Tuple[torch.Tensor, nn.Parameter]] = []
        if opt.ema is not None:
            self.ema_pairs = [(opt.ema.shadow[n], p) for n, p in opt.model.named_parameters()]
        device = self.groups[0].params[0].device
        n = _PER_GROUP * len(self.groups) + 2
        self.values = torch.zeros(n, dtype=torch.float32, device=device)
        self._host = torch.zeros(n, dtype=torch.float32, pin_memory=True)

    def state(self) -> List[torch.Tensor]:
        """Every tensor ``apply`` writes: the parameters, the moments and the
        EMA shadows."""
        return ([t for g in self.groups for t in g.params + g.exp_avgs + g.exp_avg_sqs]
                + [s for s, _ in self.ema_pairs])

    def write(self) -> None:
        """This step's values, from the host's counters, into ``values``."""
        opt = self.opt
        lr = opt.schedule(opt.count)
        beta1 = None if opt.momentum is None else opt.momentum(opt.count)
        row = []
        for g in self.groups:
            glr = lr * g.group["lr_factor"]
            b1 = g.beta1 if beta1 is None else beta1
            t = float(g.steps[0]) + 1.0
            bc1, bc2 = 1 - b1 ** t, 1 - g.beta2 ** t
            row += [1 - glr * g.weight_decay, 1 - b1, bc2 ** 0.5, (glr / bc1) * -1]
        if opt.ema is None:
            row += [0.0, 0.0]
        else:
            n = opt.ema.count + 1
            d = min(opt.ema.decay, (1.0 + n) / (10.0 + n))
            row += [d, 1.0 - d]
        self._host.numpy()[:] = row
        self.values.copy_(self._host, non_blocking=True)

    @torch.no_grad()
    def apply(self) -> None:
        """The update and the EMA from the gradients in ``.grad``."""
        v = self.values
        for i, g in enumerate(self.groups):
            P, M, V = g.params, g.exp_avgs, g.exp_avg_sqs
            G = [p.grad for p in P]
            row = i * _PER_GROUP
            if g.weight_decay != 0:
                if g.decoupled:
                    torch._foreach_mul_(P, v[row + _DECAY])
                else:
                    G = torch._foreach_add(G, P, alpha=g.weight_decay)
            if g.beta1 is not None:
                torch._foreach_lerp_(M, G, 1 - g.beta1)
            else:
                for m, grad in zip(M, G):
                    m.lerp_(grad, v[row + _LERP])
            torch._foreach_mul_(V, g.beta2)
            torch._foreach_addcmul_(V, G, G, 1 - g.beta2)
            den = torch._foreach_sqrt(V)
            torch._foreach_div_(den, v[row + _BC2])
            torch._foreach_add_(den, g.eps)
            step = v[row + _STEP]
            for p, q in zip(P, torch._foreach_div(M, den)):
                p.addcmul_(q, step)
        if self.ema_pairs:
            torch._foreach_mul_([s for s, _ in self.ema_pairs], v[-2])
            for s, p in self.ema_pairs:
                s.addcmul_(p, v[-1])

    def commit(self) -> None:
        """Move the host's counters as a taken ``Optimizer.step`` does."""
        opt = self.opt
        lr = opt.schedule(opt.count)
        for group in opt.inner.param_groups:
            group["lr"] = lr * group["lr_factor"]
            if opt.momentum is not None:
                group["betas"] = (opt.momentum(opt.count), group["betas"][1])
        torch._foreach_add_(self.steps, 1.0)
        opt.count += 1
        if opt.ema is not None:
            opt.ema.count += 1


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
