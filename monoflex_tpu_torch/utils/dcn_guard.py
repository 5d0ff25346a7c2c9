"""The clamp guard for the bounded-window DCN impls, after a checkpoint restore
(counterpart of ``monoflex_tpu/utils/dcn_guard.py``).

The clamped impls ("shift", "pallas*", the port's Hopper kernels) clamp the
learned offsets to +-R, where the reference CUDA op is unbounded.  Weights
trained with unbounded offsets (the reference's, or this package's "gather"
impl) can put most of their sampling taps outside the window, and silently
clamping them measured AP 0.00 on the TPU (the JAX package's round-2 clamp
ablation).  After a restore the guard runs ONE batch through the model with
every neck stage routed onto the unbounded "gather" op (the JAX guard builds
a gather copy; routing the same parameters is that model, and the routes
are put back after), reads every DCN's offsets with forward hooks on the
offset/mask convs (nothing on the model's own path), and per neck stage
takes the share of |offset| beyond that stage's R.  A bounded stage
whose share passes ``TPU.DCN_GUARD_THRESHOLD`` fires the guard:

- ``TPU.DCN_OFFSET_GUARD = "warn"`` (the default): log the per-stage table
  and the suggested per-stage impls;
- ``"auto"``: also return that suggestion, the saturating stages on
  "gather", for the caller to reroute the model (``reroute``);
- ``"off"``: no scan.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.backbone.dla import (BOUNDED_IMPLS, DCN, N_DCN_STAGES, resolve_dcn_specs,
                                   resolve_dcn_stages, set_dcn_specs)


def stage_of(name: str) -> Optional[int]:
    """The neck stage of a module name: ``dla_up.ida_k`` is stage k, the
    final ``ida_up`` the last stage."""
    m = re.search(r"(?:^|\.)ida_(\d+|up)(?:\.|$)", name)
    if not m:
        return None
    return N_DCN_STAGES - 1 if m.group(1) == "up" else int(m.group(1))


def scan_offset_saturation(cfg, model: torch.nn.Module, batch: Dict[str, torch.Tensor]
                           ) -> List[Dict]:
    """Per-stage |offset| statistics of ``model``'s weights under the
    unbounded (gather) DCN on one batch: one row per neck stage that has
    DCNs, so none for a model without them (``dla34_nodcn``, the dlav0
    family, where the JAX guard raises instead).  ``model`` is left as it
    was."""
    dcns = [(name, m) for name, m in model.named_modules() if isinstance(m, DCN)]
    if not dcns:
        return []
    impls, rs = resolve_dcn_stages(cfg)
    per_stage: Dict[int, List[np.ndarray]] = {}

    def hook(stage):
        def record(_module, _inputs, out):
            offsets = out[:, :18].float().abs().flatten().cpu().numpy()
            per_stage.setdefault(stage, []).append(offsets)
        return record

    specs = {name: m.spec for name, m in dcns}
    scan_cfg = cfg.clone()
    scan_cfg.defrost()
    # offsets come from plain convs: on the unbounded gather they show what
    # the weights want, whatever the clamp
    scan_cfg.TPU.DCN_IMPL_PER_STAGE = ("gather",) * N_DCN_STAGES
    handles = []
    was_training = model.training
    try:
        set_dcn_specs(model.backbone, resolve_dcn_specs(scan_cfg))
        handles = [m.conv_offset_mask.register_forward_hook(hook(stage_of(name)))
                   for name, m in dcns]
        model.eval()
        with torch.no_grad():
            model(batch["image"], batch.get("edge_indices"), batch.get("edge_len"))
    finally:
        for h in handles:
            h.remove()
        for name, m in dcns:
            m.spec = specs[name]
        model.train(was_training)

    rows = []
    for stage in range(N_DCN_STAGES):
        if stage not in per_stage:
            continue
        v = np.concatenate(per_stage[stage])
        r = float(rs[stage])
        rows.append({
            "stage": stage,
            "impl": impls[stage],
            "bounded": impls[stage] in BOUNDED_IMPLS,
            "R": r,
            "p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99)),
            "max": float(v.max()),
            "frac_clipped": float((v > r).mean()),
        })
    return rows


def dcn_offset_guard(cfg, model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                     logger: Optional[logging.Logger] = None,
                     ) -> Tuple[bool, Optional[Tuple[str, ...]], List[Dict]]:
    """(fired, suggested per-stage impls or None, per-stage rows), as the JAX
    guard returns them: the suggestion only under "auto" when a bounded stage
    saturates, with the other stages on their configured impl."""
    mode = cfg.TPU.DCN_OFFSET_GUARD
    if mode == "off":
        return False, None, []
    logger = logger or logging.getLogger("monoflex")
    threshold = float(cfg.TPU.DCN_GUARD_THRESHOLD)

    rows = scan_offset_saturation(cfg, model, batch)
    saturating = [r for r in rows if r["bounded"] and r["frac_clipped"] > threshold]
    if not saturating:
        return False, None, rows

    suggestion = tuple("gather" if r in saturating else r["impl"] for r in rows)
    table = "\n".join(
        f"  stage {r['stage']} impl={r['impl']:8s} R={r['R']:.0f} "
        f"|offset| p50={r['p50']:.2f} p99={r['p99']:.2f} max={r['max']:.2f} "
        f"frac>{r['R']:.0f}px={r['frac_clipped']:.1%}"
        + ("  <-- SATURATES" if r in saturating else "")
        for r in rows)
    logger.warning(
        "DCN OFFSET GUARD: this checkpoint's learned offsets exceed the "
        "bounded DCN window on %d neck stage(s): the clamped kernels would "
        "silently discard its sampling taps (measured outcome on the TPU: AP ~0).\n%s\n"
        "Fix: set TPU.DCN_IMPL_PER_STAGE %s (or TPU.DCN_OFFSET_GUARD auto).",
        len(saturating), table, list(suggestion))
    return True, (suggestion if mode == "auto" else None), rows


def reroute(cfg, model: torch.nn.Module, impls: Tuple[str, ...]) -> None:
    """Set ``TPU.DCN_IMPL_PER_STAGE`` of ``cfg`` to ``impls`` and route
    ``model``'s neck stages by it, in place: the model keeps its parameters
    (and an optimizer built on them stays valid), and its kernel stages stay
    on the kernels or on the plain op as the model was built."""
    frozen = cfg.is_frozen()
    cfg.defrost()
    cfg.TPU.DCN_IMPL_PER_STAGE = tuple(impls)
    if frozen:
        cfg.freeze()
    set_dcn_specs(model.backbone, resolve_dcn_specs(cfg, model.backbone.use_dcn_kernel))
