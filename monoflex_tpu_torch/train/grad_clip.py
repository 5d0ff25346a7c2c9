"""Adaptive gradient clipping (counterpart of the optax transform
``monoflex_tpu/train/grad_clip.py``; reference: utils/grad_clip.py:4-30,
shipped but unused; the trainer clips to a fixed global norm when
SOLVER.GRAD_NORM_CLIP > 0): keep an exponential moving average of the
global gradient norm and clip the gradients to ``factor`` times it.

``AdaptiveGradClip(factor, alpha)`` is called on the parameters after the
backward, before the optimizer's step; its state is the average and whether
it has seen a step (the optax state's two fields).
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch


class AdaptiveGradClip:
    def __init__(self, factor: float = 1.5, alpha: float = 0.9):
        self.factor = factor
        self.alpha = alpha
        self.ema_norm = torch.zeros(())
        self.initialized = False

    @torch.no_grad()
    def __call__(self, params: Iterable[torch.nn.Parameter]) -> torch.Tensor:
        """Clip the ``.grad`` of ``params`` in place; returns the scale."""
        grads = [p.grad for p in params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        ema = self.alpha * self.ema_norm.to(norm) + (1 - self.alpha) * norm \
            if self.initialized else norm
        limit = self.factor * ema
        scale = limit / (norm + 1e-12) if self.initialized and bool(norm > limit) \
            else torch.ones_like(norm)
        for g in grads:
            g.mul_(scale)
        self.ema_norm, self.initialized = ema, True
        return scale

    def state_dict(self) -> Dict[str, object]:
        return {"ema_norm": self.ema_norm, "initialized": self.initialized}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.ema_norm = torch.as_tensor(state["ema_norm"])
        self.initialized = bool(state["initialized"])
