"""The plain reference as the benchmark drives it: the model of a
configuration file in the precision the configuration states (float32 with
TF32 off; under ``TPU.COMPUTE_DTYPE`` "bfloat16" the trunk, neck and head
towers in bf16 as the configuration puts them, everything else float32),
its training steps with AdamW, and the KITTI sample encoding of the data
layer.

The reference is a frozen copy of the program's plain modules (the DCN is
the plain PyTorch gather of ``dcn.py``, with the configuration's offset clamp
and the rounding of x it states) and imports nothing of the program.  It
makes its own weights from the seed: the model's seeded init (``detector.py``)
and the benchmark's part of them (``mfbench/weights.py``).

``precision`` selects the reference or a control, the same arithmetic one
step below what the configuration states:

- "stated": the configuration's own precision, TF32 off;
- "tf32": the same with TF32 on (the control of a float32 configuration);
- "fp8": the convolutions the configuration runs in bfloat16 take their
  input and kernel rounded to float8 e4m3 with a per-tensor scale, and
  their input gradient to e5m2 (the control of a bfloat16 configuration).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..weights import apply_recipe
from .config import Config
from .dataset import KITTIDataset
from .augmentations import RandomHorizontalFlip
from .detector import build_model
from .layers import Conv2d
from .loss_computation import LossComputer
from .postprocessor import PostProcessor
from .solver import build_optimizer

PRECISIONS = ("stated", "tf32", "fp8")
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _scaled_round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    s = t.detach().abs().amax().float().clamp_min(1e-30) / top
    return ((t.float() / s).to(dtype).float() * s).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _scaled_round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


def set_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.benchmark = False


def build(tree: Dict, weights: Dict, seed: int, device, precision: str = "stated"):
    """(model, config) of a configuration file's ``cfg`` tree and
    ``weights`` in ``precision``."""
    cfg = Config(tree)
    model = build_model(cfg, device=device, seed=seed, use_dcn_kernel=False)
    apply_recipe(model, seed, weights)
    if precision == "fp8":
        for m in model.modules():
            if isinstance(m, Conv2d) and m.compute_dtype == torch.bfloat16:
                m.fake_quant = fp8
    set_precision(precision)
    return model, cfg


def upload(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def forward_backward(model, loss_computer, batch):
    model.train()
    for p in model.parameters():
        p.grad = None
    outputs = model(batch["image"], batch.get("edge_indices"), batch.get("edge_len"))
    loss_dict, _ = loss_computer(outputs, batch)
    total = sum(loss_dict[k] for k in sorted(loss_dict))
    total.backward()
    return total.detach()


@torch.no_grad()
def bn_stats(model) -> Dict[str, torch.Tensor]:
    """Every BatchNorm running statistic, by name, copied to the host."""
    return {n: b.detach().float().cpu().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


@torch.no_grad()
def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    values = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names])
    return dict(zip(names, values.tolist()))


def dcn_specs(model, specs: List) -> List:
    """Forward pre-hooks that append, for each DCN call of ``model`` in
    forward order, (max_offset, transfer dtype, x's (B, H, W, C)) to
    ``specs``; returns the hooks' handles."""
    from .dla import DCN

    def hook(mod, args):
        B, C, H, W = args[0].shape
        specs.append((mod.spec.max_offset, mod.spec.transfer_dtype, (B, H, W, C)))

    return [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, DCN)]


def train_record(tree: Dict, weights: Dict, seed: int, device, batches: List[Dict],
                 steps_per_epoch: int, precision: str = "stated") -> Dict[str, object]:
    """The reference's first ``len(batches)`` training steps from the seed:
    each step's total loss, the norm of each parameter's first gradient as
    AdamW receives it (from its first moment after one step), the BatchNorm
    statistics after the first step (and before it), the norm of each
    parameter's change over all the steps, and its DCN calls' clamp,
    transfer dtype and input shape in the first step's forward order."""
    model, cfg = build(tree, weights, seed, device, precision)
    optimizer, _, _ = build_optimizer(cfg, model, steps_per_epoch)
    loss_computer = LossComputer(cfg)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    initial = bn_stats(model)
    losses, grads, stats, specs = [], None, None, []
    for i, batch in enumerate(batches):
        hooks = dcn_specs(model, specs) if i == 0 else []
        losses.append(float(forward_backward(model, loss_computer, upload(batch, device))))
        for h in hooks:
            h.remove()
        optimizer.step()
        if i == 0:
            beta1 = optimizer.inner.param_groups[0]["betas"][0]
            state = optimizer.inner.state
            grads = norms({n: state[p]["exp_avg"] / (1 - beta1)
                           for n, p in model.named_parameters() if p in state})
            stats = bn_stats(model)
    delta = norms({n: p.detach() - start[n] for n, p in model.named_parameters()})
    return {"losses": losses, "grad_norms": grads, "delta_norms": delta, "bn_stats": stats,
            "bn_initial": initial, "dcn_specs": specs}


class KittiSamples:
    """The training set's samples as the data layer should make them: each
    frame unflipped and flipped (the flip is the augmentation's one random
    draw per sample, which the reference cannot replay)."""

    def __init__(self, tree: Dict, root: str):
        cfg = Config(tree)
        self.plain = KITTIDataset(cfg, root, is_train=True, augment=False)
        self.flipped = KITTIDataset(cfg, root, is_train=True, augment=False)
        self.flipped.augmentations = [RandomHorizontalFlip(1.0)]
        self.index = {int(f[:6]): i for i, f in enumerate(self.plain.image_files)}

    def candidates(self, image_id: int) -> List[Dict[str, np.ndarray]]:
        i = self.index[int(image_id)]
        return [self.plain[i], self.flipped[i]]


def decoder(tree: Dict) -> PostProcessor:
    return PostProcessor(Config(tree))
