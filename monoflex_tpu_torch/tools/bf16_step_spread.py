"""How far the bf16 model's training step on the DCN kernels lands from the
same step on the plain op, over several training states, beside how far the
plain-op step lands from itself and from a step that computes another
function.

    python -m monoflex_tpu_torch.tools.bf16_step_spread [--seeds 0,0,1,2,3] [--steps 6]
        [--deterministic] [--dtype float32]

For each seed s: ``runs/monoflex_bf16.yaml`` at 384x1280, batch 8, seeded
weights (seed s, the offset/mask convs perturbed with seed s + 1, as
chip_smoke.py's configs phase does for s = 0), ``--steps`` train-mode steps
on the kernels, then from the saved state the step with the BN statistics
fixed (``fixed_stats_step``) on the kernels, twice on the plain op, and on
the kernels with every stage's clamp one pixel narrower (another function,
to show what a limit on these distances lets through).  Each pair is read
as chip_smoke.py reads it (``step_distances``).  Prints one JSON line per
seed.  Exits non-zero without a card.

Whether the steps repeat: a seed given twice reads, in its second line,
``state_max_abs_diff``, the largest difference between the two trained
states.  ``--deterministic`` turns cuDNN's autotune off and sets
``torch.use_deterministic_algorithms(True, warn_only=True)``; each line then
lists, under ``nondeterministic_ops``, the ops that warned that they have no
deterministic implementation.  ``--dtype float32`` runs the f32 model
(``runs/monoflex.yaml``) instead of the bf16 one.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings
from typing import Dict, Tuple

import torch

from ..config import get_cfg_defaults
from ..data.synthetic import make_train_batch
from ..losses.loss_computation import LossComputer
from ..models.detector import build_model
from ..train.solver import build_optimizer
from ..train.train_step import TrainState, make_train_step
from . import require_cuda
from .step_drift import perturb_offset_convs

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def fixed_stats_step(state: dict, cfg, batch: dict, use_kernel: bool
                     ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The 11 terms' sum and every gradient of the model at ``state`` with
    BN on its running statistics (eval mode), through the kernels or the
    plain op."""
    model = build_model(cfg, device="cuda", use_dcn_kernel=use_kernel)
    model.load_state_dict(state)
    model.eval()
    out = model(batch["image"], batch["edge_indices"], batch["edge_len"])
    terms = LossComputer(cfg)(out, batch)[0]
    total = sum(terms[k] for k in sorted(terms))
    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return total.item(), grads


def step_distances(a: Tuple[float, Dict[str, torch.Tensor]],
                   b: Tuple[float, Dict[str, torch.Tensor]]) -> Dict[str, object]:
    """Step ``a`` against step ``b`` (the reference): the sums' relative
    error, and each nonzero gradient's relative L2 error, as their median
    and their worst with its parameter."""
    (a_total, a_grads), (b_total, b_grads) = a, b
    if a_grads.keys() != b_grads.keys():
        raise AssertionError("the two steps reach different parameters")
    errs = {n: ((a_grads[n] - g).norm() / g.norm()).item() for n, g in b_grads.items()
            if g.abs().max() > 0}
    worst = max(errs, key=errs.get)
    return {"loss_rel_err": abs(a_total - b_total) / abs(b_total),
            "grad_median": sorted(errs.values())[len(errs) // 2],
            "grad_worst": errs[worst], "worst_param": worst, "params": len(errs)}


def trained_state(cfg, seed: int, steps: int, batch: dict) -> dict:
    """The weights after ``steps`` train-mode steps on the kernels from the
    seeded model."""
    model = build_model(cfg, device="cuda", seed=seed)
    perturb_offset_convs(model, seed=seed + 1, weight_scale=0.2)
    optimizer, _, _ = build_optimizer(cfg, model)
    train_step = make_train_step(model, LossComputer(cfg), optimizer)
    state = TrainState()
    for _ in range(steps):
        state, _ = train_step(state, batch)
    return {k: v.clone() for k, v in model.state_dict().items()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", default="0,0,1,2,3",
                        help="weight seeds, comma-separated (a repeat shows the run-to-run spread)")
    parser.add_argument("--steps", type=int, default=6,
                        help="train-mode steps before the comparison (chip_smoke.py's: 1 + 5)")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--deterministic", action="store_true",
                        help="cuDNN autotune off, torch's deterministic algorithms (warn only)")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    args = parser.parse_args()
    require_cuda("bf16_step_spread")
    cfg = get_cfg_defaults()
    yaml = "monoflex_bf16.yaml" if args.dtype == "bfloat16" else "monoflex.yaml"
    cfg.merge_from_file(os.path.join(ROOT, "runs", yaml))
    if args.deterministic:
        # cuBLAS needs a fixed workspace for repeatable reductions
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        cfg.CUDNN_BENCHMARK = False
        torch.use_deterministic_algorithms(True, warn_only=True)
    narrow = cfg.clone()
    narrow.TPU.DCN_MAX_OFFSET_PER_STAGE = tuple(
        r - 1 for r in (cfg.TPU.DCN_MAX_OFFSET_PER_STAGE or (cfg.TPU.DCN_MAX_OFFSET,) * 4))
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_train_batch(args.batch).items()}
    states = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state = trained_state(cfg, seed, args.steps, batch)
            plain = fixed_stats_step(state, cfg, batch, False)
            rec = {"seed": seed, "steps": args.steps, "dtype": args.dtype,
                   "deterministic": args.deterministic,
                   "device": torch.cuda.get_device_name(0)}
            if seed in states:
                rec["state_max_abs_diff"] = max(
                    (v.float() - states[seed][k].float()).abs().max().item()
                    for k, v in state.items() if v.is_floating_point())
            for label, c, kernel in (("kernel", cfg, True), ("plain_again", cfg, False),
                                     ("narrower_clamp", narrow, True)):
                rec[label] = step_distances(fixed_stats_step(state, c, batch, kernel), plain)
        if args.deterministic:
            rec["nondeterministic_ops"] = sorted({str(w.message).split(".")[0] for w in caught
                                                  if "deterministic" in str(w.message)})
        print(json.dumps(rec), flush=True)
        states.setdefault(seed, state)
        del plain
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
