"""How far a training step on the DCN kernels lands from the same step on the
plain op, and which kernel moves it.

    python -m monoflex_tpu_torch.tools.step_drift [--states 2,4,6] [--plain fwd,dwmo,dx]

Trains ``runs/monoflex.yaml`` at 384x1280, batch 8, on the kernels (the model
and offset/mask convs of chip_smoke.py's train phase), and at each step count
in ``--states`` takes the saved state through one kernel step and one plain-op
step, x in f32 (pallas3), and compares the total loss and every parameter's
gradient (``step_drift``, which chip_smoke.py's train phase holds to its
tolerances).  Then it repeats each comparison with each kernel named in
``--plain`` replaced by its plain version, to tell which kernel moves the
step.  Prints one JSON line per (state, replaced kernels).  Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Sequence

import torch

from ..config import get_cfg_defaults
from ..data.synthetic import make_train_batch
from ..losses.loss_computation import LossComputer
from ..models.backbone.dla import DCN
from ..models.detector import build_model
from ..ops import dcn_cuda
from ..ops.dcn import modulated_deform_conv, modulated_deform_conv_backward
from ..train.solver import build_optimizer
from ..train.train_step import TrainState, forward_backward, make_train_step
from . import require_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@torch.no_grad()
def perturb_offset_convs(model: torch.nn.Module, seed: int, weight_scale: float = 2.0) -> None:
    """The offset/mask convs start at zero (no deformation).  Give them
    seeded weights so offsets are fractional and some pass +-R."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, DCN):
            conv = m.conv_offset_mask
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g)
                              * weight_scale / conv.weight[0].numel() ** 0.5)
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=g))


def feeds_train_bn(name: str) -> bool:
    """A bias whose conv output goes straight into a train-mode BN: its
    gradient is 0 in exact arithmetic."""
    return name.endswith("conv.bias") and ".conv_offset_mask." not in name or (
        name.startswith("heads.predictor.trunc_") and name.endswith(".0.bias"))


def step_drift(state: dict, cfg, batch: dict) -> Dict[str, object]:
    """One kernel step and one plain-op step from ``state``, x in f32: the
    total loss's relative error, the worst relative L2 error of a gradient
    (and its parameter), the largest gradient element of a bias that feeds a
    train-mode BN (0 in exact arithmetic) and the largest gradient element of
    the plain step."""
    cfg = cfg.clone()
    cfg.TPU.DCN_FORCE_IMPL = "pallas3"
    grads, totals = {}, {}
    for label, use_kernel in (("kernel", True), ("plain", False)):
        model = build_model(cfg, device="cuda", use_dcn_kernel=use_kernel)
        model.load_state_dict(state)
        totals[label] = forward_backward(model, LossComputer(cfg), batch)[0].item()
        grads[label] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        del model
    if grads["kernel"].keys() != grads["plain"].keys():
        raise AssertionError("the kernel and plain-op steps reach different parameters")
    worst_rel, worst_name, worst_zero = 0.0, None, 0.0
    for name, ref in grads["plain"].items():
        got = grads["kernel"][name]
        if not torch.isfinite(got).all():
            raise AssertionError(f"gradient of {name} is not finite")
        if feeds_train_bn(name):
            worst_zero = max(worst_zero, got.abs().max().item(), ref.abs().max().item())
        elif ref.norm() > 0:
            rel = ((got - ref).norm() / ref.norm()).item()
            if rel > worst_rel:
                worst_rel, worst_name = rel, name
    return {"total_kernel": totals["kernel"], "total_plain": totals["plain"],
            "loss_rel_err": abs(totals["kernel"] - totals["plain"]) / abs(totals["plain"]),
            "grad_rel_l2": worst_rel, "worst_param": worst_name, "zero_grad_max": worst_zero,
            "grad_max": max(g.abs().max().item() for g in grads["plain"].values()),
            "params": len(grads["plain"])}


def _plain_fwd(xt, offset, mask, weight, bias, max_offset, epilogue=None, bf16_math=False,
               round_x=False):
    return modulated_deform_conv(xt.float(), offset, mask, weight, bias, max_offset=max_offset)


def _plain_dwmo(x, offset, mask, weight, g, *, max_offset, compute_dtype=torch.float32):
    _, doffset, dmask, dweight, _ = modulated_deform_conv_backward(
        x.float(), offset, mask, weight, g, max_offset=max_offset,
        wrt=("offset", "mask", "weight"))
    return dmask, dweight, doffset


def _plain_dx(x, offset, mask, weight, g, *, max_offset, compute_dtype=torch.float32):
    return modulated_deform_conv_backward(x.float(), offset, mask, weight, g,
                                          max_offset=max_offset, wrt=("x",))[0]


# kernel -> (attribute of ops/dcn_cuda.py the kernel step calls, its plain version)
PLAIN = {"fwd": ("_fwd_kernel", _plain_fwd), "dwmo": ("dcn_bwd_dwmo", _plain_dwmo),
         "dx": ("dcn_bwd_dx", _plain_dx)}


def drift_with_plain(state: dict, cfg, batch: dict, plain: Sequence[str]) -> Dict[str, object]:
    """``step_drift`` with the kernels named in ``plain`` replaced by their
    plain versions in the kernel step."""
    saved = {name: getattr(dcn_cuda, PLAIN[name][0]) for name in plain}
    try:
        for name in plain:
            setattr(dcn_cuda, PLAIN[name][0], PLAIN[name][1])
        return step_drift(state, cfg, batch)
    finally:
        for name, fn in saved.items():
            setattr(dcn_cuda, PLAIN[name][0], fn)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--states", default="2,4,6",
                        help="step counts at which to compare, comma-separated")
    parser.add_argument("--plain", default="fwd,dwmo,dx",
                        help="kernels to replace one at a time, comma-separated (or empty)")
    parser.add_argument("--batch", type=int, default=8)
    args = parser.parse_args()
    states = sorted(int(s) for s in args.states.split(","))
    plain = [p for p in args.plain.split(",") if p]
    unknown = [p for p in plain if p not in PLAIN]
    if unknown:
        raise SystemExit(f"step_drift: --plain takes {sorted(PLAIN)}, not {unknown}")
    require_cuda("step_drift")
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
    model = build_model(cfg, device="cuda", seed=0)
    perturb_offset_convs(model, seed=1, weight_scale=0.2)
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_train_batch(args.batch).items()}
    optimizer, _, _ = build_optimizer(cfg, model)
    train_step = make_train_step(model, LossComputer(cfg), optimizer)
    state, done = TrainState(), 0
    for target in states:
        while done < target:
            state, _ = train_step(state, batch)
            done += 1
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        for replaced in [()] + [(p,) for p in plain]:
            rec = drift_with_plain(saved, cfg, batch, replaced)
            print(json.dumps({"state": target, "plain": list(replaced),
                              "device": torch.cuda.get_device_name(0), **rec}), flush=True)


if __name__ == "__main__":
    main()
