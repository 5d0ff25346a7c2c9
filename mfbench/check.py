"""How ``correct`` is decided: numbers that compare the timed path's results
with the reference's, each compared against its limit in
``limits/<cell>.json`` (the cell's file names the numbers it compares; the
others are computed for ``calibrate.py``, whose readings set the limits).

Training cells compare the first three steps, which set-up drove through
the window's own call and feed, with the reference's three from the same
seed and the same raw inputs:

- ``data_gap`` (a cell fed by the data layer): the largest absolute
  difference between a batch the loader made and the reference's encoding
  of the same frames, flipped where the loader's image is (exact);
- ``bn_median_gap``: the median BatchNorm statistic's gap after step 1;
- ``loss1_gap`` / ``loss_gap``: the first / the largest relative gap of a
  step's total loss;
- ``grad_gap`` / ``grad_median_gap``: the worst / the median parameter's
  gap between the norms of its first gradient (as the optimizer received
  it), over the larger of the reference's norm and the median parameter's
  (the median: over the reference's own norm);
- ``delta_gap`` / ``delta_median_gap``: the same for each parameter's
  change over the three steps, leaving out parameters whose reference
  gradient is under a thousandth of the median's (they move by round-off);
- ``dcn_grad_gap``: the DCN backward alone.  At a few of the first step's
  DCN calls, drawn from the seed, the program's op kept its operands, the
  output gradient g it received and the gradients it returned (dx,
  d offset, d mask, dW); the reference's plain backward of the same
  operands and g gives its own, and each gradient's gap is the norm of the
  difference over the reference's norm; the largest over calls and
  gradients.  It takes the program's own operands and g: the stages before
  (the forward up to the DCN, the backward from the loss down to g) are
  the other numbers' to judge.

Inference cells compare a sample of the calls finished in the window,
drawn from the seed, with the reference's forward and decode of the same
inputs, peak by peak:

- ``pick_gap`` / ``pick_median_gap`` / ``pick_p90_gap``: over the peaks the
  program picked, the largest / median / 90th percentile amount by which
  the reference's heatmap score there lies below the reference's K-th best
  peak or below the highest score around it (near-ties cost their gap);
- ``rows_gap`` / ``rows_median_gap``: the largest / median over rows of a
  row's worst field gap to the reference's decode of the same peak,
  relative to the reference's value plus the field's scale; the two angles
  (wrapped) count only where the reference's orientation bin wins by
  ``ori_margin`` or more.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# row layout: [cls, alpha, x1, y1, x2, y2, h, w, l, x, y, z, roty, score]
ANGLES = (1, 12)
# the scale added to |reference| per field (pixels, metres, score)
FIELD_SCALE = np.array([1.0, np.pi, 16, 16, 16, 16, 1, 1, 1, 1, 1, 1, np.pi, 0.05])
GRAD_FLOOR = 1e-3


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], names: List[str]
               ) -> Tuple[float, str]:
    """max over ``names`` of |prog - ref| / max(ref, median ref)."""
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not np.all(np.isfinite(prog["losses"])):
        losses = [float("inf")]
    g_ref = ref["grad_norms"]
    names = sorted(g_ref)
    if sorted(prog["grad_norms"]) != names or sorted(prog["delta_norms"]) != sorted(
            ref["delta_norms"]):
        return {k: float("inf") for k in ("loss_gap", "loss1_gap", "grad_gap", "grad_median_gap",
                                          "delta_gap", "delta_median_gap", "bn_median_gap")}
    grad_gap, _ = worst_leaf(prog["grad_norms"], g_ref, names)
    med = statistics.median(g_ref[n] for n in names)
    moved = [n for n in names if g_ref[n] >= GRAD_FLOOR * med]
    delta_gap, _ = worst_leaf(prog["delta_norms"], ref["delta_norms"], moved)
    return {"loss_gap": max(losses), "loss1_gap": losses[0], "grad_gap": grad_gap,
            "grad_median_gap": median_leaf(prog["grad_norms"], g_ref, names),
            "delta_gap": delta_gap,
            "delta_median_gap": median_leaf(prog["delta_norms"], ref["delta_norms"], moved),
            "bn_median_gap": bn_gap(prog["bn_stats"], ref["bn_stats"], ref["bn_initial"])}


DCN_GRADS = ("dx", "doffset", "dmask", "dweight")


@torch.no_grad()
def dcn_grad_gap(calls: Dict[int, Dict[str, torch.Tensor]], specs: List[Tuple], device,
                 precision: str = "stated") -> float:
    """``calls``: {call index: the recorded operands x, offset, mask, weight,
    the output gradient g and the program's gradients}; ``specs``: the
    reference's (max_offset, transfer dtype, x's shape) of each DCN call in
    forward order.  With a control's ``precision`` the reference's backward
    in that precision takes the program's place."""
    from .reference.dcn import modulated_deform_conv_backward
    from .reference.model import set_precision

    if not calls:
        return float("inf")
    worst = 0.0
    for k, rec in sorted(calls.items()):
        if k >= len(specs) or any(n not in rec for n in ("g",) + DCN_GRADS):
            return float("inf")
        max_offset, transfer, shape = specs[k]
        if tuple(rec["x"].shape) != tuple(shape):
            return float("inf")
        t = {n: v.to(device) for n, v in rec.items()}
        args = (t["x"], t["offset"], t["mask"], t["weight"], t["g"])
        kw = dict(max_offset=max_offset, transfer_dtype=transfer)
        ref = modulated_deform_conv_backward(*args, **kw)[:4]
        got = [t[n] for n in DCN_GRADS]
        if precision != "stated":
            set_precision(precision)
            got = modulated_deform_conv_backward(*args, **kw)[:4]
            set_precision("stated")
        for p, r in zip(got, ref):
            if p.shape != r.shape:
                return float("inf")
            gap = float((p.float() - r).norm() / r.norm().clamp_min(1e-30))
            worst = max(worst, gap if np.isfinite(gap) else float("inf"))
        del t, ref, got
    return worst


def bn_gap(prog: Dict, ref: Dict, initial: Dict) -> float:
    """The median over BatchNorm statistics of |prog - ref| / |ref - initial|
    (L2 norms) after the first step: the first batch's statistics, which
    the forward's trunk sets before any DCN has run."""
    if sorted(prog) != sorted(ref):
        return float("inf")
    gaps = [float((prog[n] - ref[n]).norm() / (ref[n] - initial[n]).norm().clamp_min(1e-30))
            for n in ref]
    return statistics.median(gaps)


def median_leaf(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> float:
    """The median over ``names`` of |prog - ref| / ref."""
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], 1e-30) for n in names)


def data_gap(batch: Dict[str, np.ndarray], candidates: List[List[Dict[str, np.ndarray]]]
             ) -> Tuple[float, Dict[str, np.ndarray]]:
    """The loader's batch against the reference's samples of the same
    frames, each held to the candidate (flipped or not) whose image it
    carries: (the largest absolute difference of any field, the
    reference's batch).  A sample that matches neither reads inf."""
    worst, picked = 0.0, []
    for i, options in enumerate(candidates):
        match = [c for c in options if np.array_equal(c["image"], batch["image"][i])]
        ref = match[0] if match else options[0]
        picked.append(ref)
        if not match or set(ref) != set(batch):
            worst = float("inf")
            continue
        for key, value in ref.items():
            got = np.asarray(batch[key][i])
            if got.shape != np.shape(value):
                worst = float("inf")
                continue
            diff = np.abs(got.astype(np.float64) - np.asarray(value, dtype=np.float64))
            worst = max(worst, float(np.nan_to_num(diff, nan=np.inf).max(initial=0.0)))
    return worst, {k: np.stack([p[k] for p in picked]) for k in picked[0]}


def wrapped(a: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a + np.pi, 2 * np.pi) - np.pi


@torch.no_grad()
def infer_numbers(pred: Dict, post, batch: Dict[str, torch.Tensor], rows: torch.Tensor,
                  points: torch.Tensor, ori_margin: float) -> Dict[str, float]:
    """``pred``: the reference's head maps of ``batch``; ``rows`` (B, K, 14)
    and ``points`` (B, K, 2) [x, y]: what the program decoded."""
    from .reference.image_ops import nms_hm, select_point_of_interest

    heat = pred["cls"]
    B, C, H, W = heat.shape
    K = rows.shape[1]
    rows = rows.to(heat.device).float()
    cls = rows[..., 0].round().long().clamp(0, C - 1)
    xs = points[..., 0].to(heat.device).round().long().clamp(0, W - 1)
    ys = points[..., 1].to(heat.device).round().long().clamp(0, H - 1)
    b = torch.arange(B, device=heat.device)[:, None].expand(B, K)
    s_ref = heat[b, cls, ys, xs]
    window = F.max_pool2d(heat, 3, stride=1, padding=1)[b, cls, ys, xs]
    kth = nms_hm(heat).reshape(B, -1).topk(K, dim=1).values[:, -1:]
    picks_gap = torch.maximum(window - s_ref, kth - s_ref).clamp_min(0)

    flat = ys * W + xs
    picks = (s_ref, flat, cls.float(), ys.float(), xs.float())
    ref_rows, _, _ = post(pred, batch, picks=picks)
    diff = (rows - ref_rows).abs()
    for col in ANGLES:
        diff[..., col] = wrapped(rows[..., col] - ref_rows[..., col]).abs()
    scale = torch.as_tensor(FIELD_SCALE, dtype=diff.dtype, device=diff.device)
    gap = diff / (ref_rows.abs() + scale)
    for col in ANGLES:
        gap[..., col] = diff[..., col] / scale[col]

    k2c = post.k2c
    poi = select_point_of_interest(pred["reg"], flat)            # (B, K, ch)
    bins = torch.softmax(poi[..., k2c("ori_cls")].reshape(B, K, -1, 2), dim=-1)[..., 1]
    top2 = bins.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) >= ori_margin
    for col in ANGLES:
        gap[..., col] = torch.where(clear, gap[..., col], torch.zeros_like(gap[..., col]))
    per_row = torch.nan_to_num(gap, nan=float("inf")).amax(dim=-1)
    return {"pick_gap": float(picks_gap.max()), "pick_median_gap": float(picks_gap.median()),
            "pick_p90_gap": float(picks_gap.flatten().quantile(0.9)),
            "rows_gap": float(per_row.max()), "rows_median_gap": float(per_row.median())}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits if k in numbers}
    ok = len(table) == len(limits) and all(
        np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
