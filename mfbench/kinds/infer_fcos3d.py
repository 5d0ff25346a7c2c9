"""FCOS3D's inference cells: the evaluation path's forward and decode of one
camera-rig sample a call (``sources/camera_rig_batches.py``), each input
uploaded and its rows copied back to the host, in a closed loop.  Its
window is an inference window: ``prepare`` sets ``run.kind`` "infer", which
``metrics/infer_img_per_s.py`` reads.

Set-up: the trunk's BatchNorm statistics and then the head's class and
depth biases (``weights_fcos3d.py``) come from the reference on the pool's
first sample and are handed to both sides (their time left out of
``setup_s``, as ``kinds/infer.py`` does).  Each call keeps its rows on the host,
and the last call of each pool sample keeps, on the device, what its
decode read: the candidates (the head values at the top locations), their
locations and the rows' candidates.

The check draws ``check_calls`` of those calls from the seed and runs the
reference's forward on the same inputs:

- ``pick_p90_gap`` / ``pick_gap``: over the program's candidates, the 90th
  percentile / the largest amount by which the reference's score (class x
  centerness, at the same location) lies below the reference's own
  ``NMS_PRE``-th best of that level and image (near-ties cost their gap);
- ``maps_median_gap`` / ``maps_p90_gap``: over the candidates, the median /
  90th percentile of a candidate's largest gap between the program's head
  values and the reference's at its location, each relative to the
  reference's value plus 1 (the values are logits and log-sizes);
- the reference's decode and NMS, run on the program's own candidates (its
  maps rebuilt from them: every other location scores 0), must keep the
  program's boxes, by (location, class): ``nms_unexplained`` counts the
  images where the two sets differ while no suppression of the reference's
  had an IoU within 1e-5 of the threshold, ``nms_borderline`` the images
  that differ with such a pair; ``rows_gap`` is the largest field gap of
  a kept box (relative to the reference's value plus 1; the yaw wrapped).

With a control's ``precision`` the control's forward and the reference's
decode of it take the program's place.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np

from mfbench.harness import sync, window

NUMBERS = ("pick_gap", "pick_p90_gap", "maps_median_gap", "maps_p90_gap", "rows_gap",
           "nms_unexplained", "nms_borderline")
CLASS_COL, YAW_COL = 10, 6


def half_batch(eval_step):
    """Half of the batch left out; its images get the others' rows."""
    import torch

    def faulty(batch):
        B = batch["image"].shape[0]
        h = max(1, B // 2)
        rows, valid, extras = eval_step({k: v[:h] for k, v in batch.items()})
        idx = torch.arange(B, device=rows.device) % h
        return rows[idx], valid[idx], {k: v[idx] for k, v in extras.items()}
    return faulty


def alter_answer(eval_step):
    """Every box's depth made 20% larger where the decode produces it."""
    def faulty(batch):
        rows, valid, extras = eval_step(batch)
        rows = rows.clone()
        rows[..., 2] *= 1.2
        return rows, valid, extras
    return faulty


FAULTS = {"half_batch": half_batch, "alter_answer": alter_answer}


def prepare(session) -> None:
    """The BN statistics, through the reference, before the program is
    built; ``session.excluded_s`` takes their seconds."""
    import torch
    import torch.nn.functional as F

    from mfbench.reference_fcos3d import model as ref

    session.run.kind = "infer"
    device = session.device
    if torch.device(device).type == "cuda":
        x = torch.ones(1, 1, 4, 4, device=device)
        F.conv2d(x, torch.ones(1, 1, 3, 3, device=device))
        x.flatten()[None] @ x.flatten()[:, None]
        torch.cuda.synchronize()
    t0 = time.time()
    args = (session.tree, session.weights, session.args.seed, device, session.feed.pool[0])
    session.buffers = ref.bn_statistics(*args)
    session.weights = {**session.weights, **ref.fit_head_biases(*args, session.buffers)}
    sync(device)
    session.excluded_s += time.time() - t0


def drive(session, prog, cfg, model) -> None:
    """Warm-up calls, then the window (module docstring)."""
    from mfbench import program_fcos3d
    from mfbench.weights_fcos3d import head_biases

    run, feed, args = session.run, session.feed, session.args
    head_biases(model, session.weights)
    eval_step = program_fcos3d.eval_step(cfg, model)
    for name in session.faults:
        eval_step = FAULTS[name](eval_step)
    last: Dict[int, tuple] = {}
    bad = [0]
    spans = run.spans
    pool = len(feed.pool)

    def call(i):
        host = feed.next(i)
        with spans("upload"):
            batch = prog.to_device(host, session.device)
        with spans("forward_decode"):
            rows, valid, extras = eval_step(batch)
        with spans("rows_to_host"):
            rows, valid = rows.cpu().numpy(), valid.cpu().numpy()
        bad[0] += not np.isfinite(rows).all()
        last[i % pool] = (rows, valid, extras)

    for i in range(int(session.cell.traffic["warmup_calls"])):
        call(i)
    last.clear()
    bad[0] = 0
    spans.items.clear()
    sync(session.device)
    run.setup_s = time.time() - args.process_start - session.excluded_s
    window(run, call, args.seconds, session.trace_seconds, session.device)
    session.outputs = {"last": last, "bad": bad[0]}


def _boxes(rows, valid, extras) -> List[List[tuple]]:
    """Per image, the program's boxes as (location, class, row)."""
    loc, kept = extras["locations"].cpu(), extras["kept"].cpu()
    out = []
    for b in range(rows.shape[0]):
        out.append([(int(loc[b, int(n)]), int(round(r[CLASS_COL])), [float(v) for v in r])
                    for n, r, ok in zip(kept[b], rows[b], valid[b]) if ok])
    return out


def _flat(maps):
    """The maps (one a level) as (B, locations, channels), level by level."""
    import torch

    B = maps[0].shape[0]
    return torch.cat([m.permute(0, 2, 3, 1).reshape(B, -1, m.shape[1]).float() for m in maps], 1)


def numbers(ref_maps, cand, loc, boxes, cam) -> Dict[str, float]:
    """The check's numbers of one call (module docstring): ``cand`` (B, N,
    ch) and ``loc`` (B, N) the program's candidates, ``boxes`` its boxes."""
    import torch

    from mfbench.reference_fcos3d import fcos3d as plain
    from mfbench.reference_fcos3d import model as ref

    fields = plain.field_slices()
    cand, loc = cand.to(ref_maps[0].device).float(), loc.to(ref_maps[0].device)
    flat = _flat(ref_maps)
    B, L, ch = flat.shape
    if cand.shape[0] != B or cand.shape[-1] != ch or int(loc.max()) >= L:
        return {k: float("inf") for k in NUMBERS}
    want = flat.gather(1, loc[..., None].expand(-1, -1, ch))

    def score(t):
        return (t[..., fields["cls"]].sigmoid() * t[..., fields["centerness"]].sigmoid()).amax(-1)

    # the reference's NMS_PRE-th best score of each level, at each candidate
    kth = torch.empty_like(loc, dtype=torch.float32)
    at = 0
    all_scores = score(flat)
    for m in ref_maps:
        n = m.shape[2] * m.shape[3]
        k = min(plain.NMS_PRE, n)
        level_kth = all_scores[:, at:at + n].topk(k, dim=1).values[:, -1:]
        mine = (loc >= at) & (loc < at + n)
        kth = torch.where(mine, level_kth.expand_as(kth), kth)
        at += n
    pick = (kth - score(want)).clamp(min=0).flatten()
    gap = ((cand - want).abs() / (want.abs() + 1)).amax(-1).flatten()
    gap = torch.nan_to_num(gap, nan=float("inf"))
    out = {"pick_gap": float(pick.max()), "pick_p90_gap": float(pick.quantile(0.9)),
           "maps_median_gap": float(gap.median()), "maps_p90_gap": float(gap.quantile(0.9))}

    # the reference's decode of the program's candidates
    rebuilt = torch.zeros(B, L, ch, device=cand.device)
    rebuilt[..., fields["cls"]] = -1e4
    rebuilt[..., fields["centerness"]] = -1e4
    rebuilt.scatter_(1, loc[..., None].expand(-1, -1, ch), cand)
    maps, at = [], 0
    for m in ref_maps:
        H, W = m.shape[2:]
        maps.append(rebuilt[:, at:at + H * W].reshape(B, H, W, ch).permute(0, 3, 1, 2))
        at += H * W
    dec = ref.decode(maps, cam)
    unexplained = borderline = 0
    rows_gap = 0.0
    for b in range(B):
        got = {(loc_, c): row for loc_, c, row in boxes[b]}
        mine = {(loc_, c): row for loc_, c, row in dec["boxes"][b]}
        if set(got) != set(mine) or len(got) != len(boxes[b]):
            if dec["borderline"][b]:
                borderline += 1
            else:
                unexplained += 1
            continue
        for key, r in mine.items():
            p, q = np.asarray(got[key]), np.asarray(r)
            d = np.abs(p - q) / (np.abs(q) + 1)
            d[YAW_COL] = abs((p[YAW_COL] - q[YAW_COL] + math.pi) % (2 * math.pi) - math.pi)
            rows_gap = max(rows_gap, float(np.nan_to_num(d, nan=np.inf).max()))
    out.update(rows_gap=rows_gap, nms_unexplained=float(unexplained),
               nms_borderline=float(borderline))
    return out


def judge(session, precision: str = "stated") -> Dict[str, float]:
    """The numbers of a sample of the kept calls, drawn from the seed,
    against the reference; with ``precision``, of the control's own forward
    and the reference's decode of it.  Counts add up over the calls; gaps
    take the largest."""
    import torch

    from mfbench.reference_fcos3d import model as ref
    from mfbench.weights import load_buffers

    cell, feed = session.cell, session.feed
    last = session.outputs["last"]
    tree, weights, seed, device = session.tree, session.weights, session.args.seed, session.device
    if not last:
        return {k: float("inf") for k in cell.limits["limits"]}
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    slots = sorted(last)
    take = sorted(rng.choice(slots, size=min(len(slots), int(cell.traffic["check_calls"])),
                             replace=False).tolist())
    model = ref.build(tree, weights, seed, device)
    load_buffers(model, session.buffers)
    control = None
    if precision != "stated":
        control = ref.build(tree, weights, seed, device, precision)
        load_buffers(control, session.buffers)
        ref.set_precision("stated")
    total: Dict[str, float] = {}
    for slot in take:
        rows, valid, extras = last[slot]
        batch = ref.upload(feed.pool[slot], device)
        with torch.no_grad():
            if control is not None:
                ref.set_precision(precision)
                dec = ref.decode(control(batch["image"]), batch["cam_intrinsic"])
                ref.set_precision("stated")
                cand, loc, boxes = dec["candidates"], dec["locations"], dec["boxes"]
            else:
                cand, loc = extras["candidates"], extras["locations"]
                boxes = _boxes(rows, valid, extras)
            got = numbers(model(batch["image"]), cand, loc, boxes, batch["cam_intrinsic"])
        for k, v in got.items():
            total[k] = total.get(k, 0.0) + v if k.startswith("nms_") else max(total.get(k, 0.0), v)
    return total


def failed(session) -> int:
    """Calls whose rows are not all finite."""
    return session.outputs["bad"]
