"""BEVFormer's inference cell: the evaluation path's forward and decode of
one sample (six cameras) a call, in scene order, with the BEV history the
model carries from call to call (``sources/camera_scene_batches.py``),
each input uploaded and its rows copied back to the host, in a closed
loop.  Its window is an inference window: ``prepare`` sets ``run.kind``
"infer", which ``metrics/infer_img_per_s.py`` reads.

Set-up: the trunk's BatchNorm statistics come from the reference on the
first sample's images, and the class bias from its forward of the first
sample (``weights_bevformer.py``), handed to both sides (their time left
out of ``setup_s``, as ``kinds/infer.py`` does); the deformable attentions'
sampling-offset and attention-weight kernels and the branches' last layers
take ``weights_bevformer.py``'s seeded values on both sides.  At another input size than the
configuration's (the tests' narrow one) the BEV grid shrinks with the
image width, the depths to one layer each and the queries to 100
(``grid``), on both sides.

What the check keeps: at ``check_calls`` scene positions drawn from the
seed (always a scene start and one 10 or more samples in), the last call
at that position: the history the program was given (its BEV buffer before
the call), its BEV, class logits, box codes and rows; and the first
``chain_calls`` calls of the last scene that had them all: their BEV and
logits.

The check runs the reference on the same images, geometry and CAN bus:

- at each kept call, given the program's own history (none at a scene
  start), so that errors do not compound: ``bev_median_gap`` /
  ``bev_p99_gap``, the median / 99th percentile of |program - reference|
  over the BEV's elements over the reference BEV's RMS; ``cls_*_gap`` and
  ``boxes_*_gap``, the same percentiles of |program - reference| / (|reference|
  + 1) over the 900 queries' logits and box codes; ``pick_gap`` /
  ``pick_p90_gap``, over the program's 300 (query, class) picks, the
  largest / 90th-percentile amount by which the reference's score there
  lies below the reference's own 300th best; ``rows_gap``, the largest
  field gap of a row to the published decode (``reference_bevformer``) of
  the program's own logits and box codes at the row's query and class
  (relative to the decode's value plus 1; the yaw wrapped): the decode's
  own arithmetic, as FCOS3D's cell judges its NMS;
- on the chain, each side carrying its own history from the scene start:
  ``chain_bev_median_gap`` and ``chain_cls_p99_gap``, the largest over the
  chain's calls: the drift.

Gaps take the largest over the calls.  With a control's ``precision`` the
control's forward (given the same history) and its own chain take the
program's place.  Faults (``calibrate.py --faults``): ``history_dropped``
(every call on the no-history path), ``history_unrotated`` (the history
shifted but not rotated) and ``class_norm_dropped`` (the last class
branch without its second LayerNorm).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np

from mfbench import program_bevformer  # fails at once on a program without BEVFormer
from mfbench.harness import sync, window

NUMBERS = ("bev_median_gap", "bev_p99_gap", "cls_median_gap", "cls_p99_gap",
           "boxes_median_gap", "boxes_p99_gap", "pick_gap", "pick_p90_gap", "rows_gap",
           "chain_bev_median_gap", "chain_cls_p99_gap")
PUBLISHED = (200, 200, 6, 6, 900)   # BEV rows, columns, encoder and decoder layers, queries
YAW_COL, SCORE_COL, LABEL_COL = 6, 9, 10


def history_dropped(eval_step):
    """Every call on the no-history path."""
    import torch

    def faulty(batch):
        return eval_step({**batch, "scene_start": torch.ones_like(batch["scene_start"])})
    return faulty


def _unrotated(prev, angle_deg, h, w):
    return prev


def class_norm_dropped(model) -> None:
    """The last class branch without its second LayerNorm (the first sees
    a Linear of LayerNorm'd queries, near zero-mean and unit-variance
    already: without it a seeded branch computes almost the same)."""
    import torch

    model.cls_branches[-1][4] = torch.nn.Identity()


FAULTS = ("history_dropped", "history_unrotated", "class_norm_dropped")


def grid(session) -> Tuple[int, int, int, int, int]:
    """The BEV grid, depths and decoder queries of the run: the published
    at the configuration's input size; at another (the tests' narrow one) a
    grid a twentieth of the published side for each 1600 pixels of width,
    one encoder and one decoder layer and 100 queries, so that the trunk
    takes most of a CPU call, as it does of the card's."""
    inp = session.cell.config["cfg"]["INPUT"]
    if (session.shape["height"], session.shape["width"]) == (inp["HEIGHT_TEST"],
                                                             inp["WIDTH_TEST"]):
        return PUBLISHED
    side = max(4, round(PUBLISHED[0] * session.shape["width"] / inp["WIDTH_TEST"] / 4))
    return side, side, 1, 1, 100


def positions(seed: int, scene: int, count: int) -> List[int]:
    """The scene positions the check keeps: 0, one of 10 or more, and
    others, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 29])
    late = int(rng.integers(min(10, scene - 1), scene))
    rest = [p for p in range(1, scene) if p != late]
    more = rng.choice(rest, size=max(0, min(len(rest), count - 2)), replace=False).tolist()
    return sorted({0, late, *more})


def prepare(session) -> None:
    """The BN statistics and the class bias, through the reference, before
    the program is built (``session.excluded_s`` takes their seconds)."""
    import torch
    import torch.nn.functional as F

    from mfbench.reference_bevformer import model as ref

    session.run.kind = "infer"
    session.grid = grid(session)
    session.undo = []
    if session.grid != PUBLISHED:
        session.undo.append(program_bevformer.set_grid(*session.grid))
    device = session.device
    if torch.device(device).type == "cuda":
        x = torch.ones(1, 1, 4, 4, device=device)
        F.conv2d(x, torch.ones(1, 1, 3, 3, device=device))
        x.flatten()[None] @ x.flatten()[:, None]
        torch.cuda.synchronize()
    t0 = time.time()
    session.buffers = ref.bn_statistics(session.tree, session.weights, session.args.seed, device,
                                        session.feed.pool[0], session.grid)
    session.weights = {**session.weights, "class_bias": ref.fit_class_bias(
        session.tree, session.weights, session.args.seed, device, session.feed.next(0),
        session.buffers, session.grid)}
    sync(device)
    session.excluded_s += time.time() - t0


def drive(session, prog, cfg, model) -> None:
    """Warm-up calls, then the window (module docstring)."""
    from mfbench.weights_bevformer import perturb_attention, scale_branches

    run, feed, args, traffic = session.run, session.feed, session.args, session.cell.traffic
    unknown = set(session.faults) - set(FAULTS)
    if unknown:
        raise ValueError(f"faults {sorted(unknown)}: this cell plants {FAULTS}")
    perturb_attention(model, args.seed, session.weights)
    scale_branches(model, session.weights)
    if "class_norm_dropped" in session.faults:
        class_norm_dropped(model)
    if "history_unrotated" in session.faults:
        session.undo.append(program_bevformer.set_rotation(_unrotated))
    eval_step = program_bevformer.eval_step(cfg, model)
    if "history_dropped" in session.faults:
        eval_step = history_dropped(eval_step)
    n, chain_len = int(traffic["scene_samples"]), int(traffic["chain_calls"])
    keep = set(positions(args.seed, n, int(traffic["check_calls"])))
    kept: Dict[int, Dict] = {}
    chain: Dict[int, Dict] = {}
    done: Dict[int, Dict] = {}
    bad = [0]
    spans = run.spans

    def call(i):
        host = feed.next(i)
        k = i % n
        prev = model.prev_bev.clone() if k in keep and k > 0 else None
        with spans("upload"):
            batch = prog.to_device(host, session.device)
        with spans("forward_decode"):
            rows, valid, extras = eval_step(batch)
        with spans("rows_to_host"):
            rows, valid = rows.cpu().numpy(), valid.cpu().numpy()
        bad[0] += not np.isfinite(rows).all()
        if k not in keep and k >= chain_len:
            return
        out = {"i": i, "rows": rows[0], "valid": valid[0], "bev": extras["bev"],
               "cls": extras["cls"], "boxes": extras["boxes"],
               "queries": extras["queries"][0].cpu().numpy()}
        if k in keep:
            kept[k] = {**out, "prev": prev}
        if k < chain_len:
            if k == 0:
                chain.clear()
            chain[k] = out
            if k == chain_len - 1:
                done.clear()
                done.update(chain)

    try:
        for i in range(int(traffic["warmup_calls"])):
            call(i)
        kept.clear()
        chain.clear()
        done.clear()
        bad[0] = 0
        spans.items.clear()
        sync(session.device)
        run.setup_s = time.time() - args.process_start - session.excluded_s
        window(run, call, args.seconds, session.trace_seconds, session.device)
    finally:
        for undo in session.undo:
            undo()
    session.outputs = {"kept": kept, "chain": done, "bad": bad[0]}


def _pct(d, q: float) -> float:
    import torch

    d = d.flatten()
    if d.numel() > 2 ** 24:
        d = d[:: -(-d.numel() // 2 ** 24)]
    return float(torch.nan_to_num(d, nan=float("inf")).quantile(q))


def maps_numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """The BEV, logit and box-code gaps of one call."""
    bev_r = want["bev"].float()
    rms = float(bev_r.square().mean().sqrt())
    d = (got["bev"].to(bev_r.device).float() - bev_r).abs() / max(rms, 1e-30)
    out = {"bev_median_gap": _pct(d, 0.5), "bev_p99_gap": _pct(d, 0.99)}
    for key in ("cls", "boxes"):
        r = want[key].float()
        g = (got[key].to(r.device).float() - r).abs() / (r.abs() + 1)
        out[f"{key}_median_gap"] = _pct(g, 0.5)
        out[f"{key}_p99_gap"] = _pct(g, 0.99)
    return out


def decoded(cls, boxes, queries: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """The published decode's rows (``reference_bevformer``'s
    ``denormalize_bbox``, z to the bottom, the score, the label) of the
    given (query, class) pairs of ``cls`` and ``boxes``."""
    import torch

    from mfbench.reference_bevformer import bevformer as plain

    q = torch.as_tensor(queries, dtype=torch.long, device=cls.device)
    lab = torch.as_tensor(labels, dtype=torch.long, device=cls.device)
    b = plain.denormalize_bbox(boxes.float()[q])
    b[:, 2] = b[:, 2] - b[:, 5] * 0.5
    scores = cls.float().sigmoid()[q, lab]
    return torch.cat([b, scores[:, None], lab[:, None].float()], -1).cpu().numpy()


def picks_numbers(got: Dict, rows: np.ndarray, queries: np.ndarray, want: Dict
                  ) -> Dict[str, float]:
    """The pick gaps of the 300 rows' (query, class) against the
    reference's scores, and the rows against the published decode of the
    same side's own logits and box codes."""
    import torch

    scores = want["cls"].float().sigmoid()
    K = rows.shape[0]
    labels = rows[:, LABEL_COL].round().astype(np.int64)
    if len(queries) != K or queries.max() >= scores.shape[0] or labels.max() >= scores.shape[1]:
        return {"pick_gap": float("inf"), "pick_p90_gap": float("inf"), "rows_gap": float("inf")}
    q = torch.as_tensor(queries, dtype=torch.long, device=scores.device)
    lab = torch.as_tensor(labels, dtype=torch.long, device=scores.device)
    kth = scores.flatten().topk(K).values[-1]
    pick = (kth - scores[q, lab]).clamp(min=0)
    ref_rows = decoded(got["cls"].to(scores.device), got["boxes"].to(scores.device), queries,
                       labels)
    d = np.abs(rows.astype(np.float64) - ref_rows) / (np.abs(ref_rows) + 1)
    d[:, YAW_COL] = np.abs((rows[:, YAW_COL] - ref_rows[:, YAW_COL] + math.pi) % (2 * math.pi)
                           - math.pi)
    return {"pick_gap": float(pick.max()), "pick_p90_gap": _pct(pick, 0.9),
            "rows_gap": float(np.nan_to_num(d, nan=np.inf).max())}


def judge(session, precision: str = "stated") -> Dict[str, float]:
    """The numbers of the kept calls and the chain against the reference
    (module docstring); with ``precision``, of the control's own forward."""
    import torch

    from mfbench.reference_bevformer import model as ref
    from mfbench.weights import load_buffers

    cell, feed = session.cell, session.feed
    kept, chain = session.outputs["kept"], session.outputs["chain"]
    if not kept:
        return {k: float("inf") for k in cell.limits["limits"]}
    tree, weights, seed, device = session.tree, session.weights, session.args.seed, session.device
    g = getattr(session, "grid", PUBLISHED)
    model = ref.build(tree, weights, seed, device, grid=g)
    load_buffers(model, session.buffers)
    control = None
    if precision != "stated":
        control = ref.build(tree, weights, seed, device, precision, grid=g)
        load_buffers(control, session.buffers)
        ref.set_precision("stated")

    def inputs(i):
        s = ref.upload({k: v for k, v in feed.next(i).items() if k != "scene_start"}, device)
        return s["image"], s["lidar2img"], s["can_bus"]

    total: Dict[str, float] = {}

    def add(numbers):
        for k, v in numbers.items():
            total[k] = max(total.get(k, 0.0), v)

    with torch.no_grad():
        for k in sorted(kept):
            e = kept[k]
            prev = None if k == 0 else e["prev"]
            x = inputs(e["i"])
            want = model(*x, prev)
            if control is not None:
                got = control(*x, prev)
                C = got["cls"].shape[1]
                idx = got["cls"].float().sigmoid().flatten().topk(len(e["queries"])).indices
                q = (idx // C).cpu().numpy()
                rows = decoded(got["cls"], got["boxes"], q, (idx % C).cpu().numpy())
            else:
                got, rows, q = e, e["rows"], e["queries"]
            add(maps_numbers(got, want))
            add(picks_numbers(got, rows, q, want))
            del want, got
        if chain:
            prev_r = prev_c = None
            for k in sorted(chain):
                e = chain[k]
                x = inputs(e["i"])
                want = model(*x, prev_r)
                prev_r = want["bev"]
                if control is not None:
                    got = control(*x, prev_c)
                    prev_c = got["bev"]
                else:
                    got = e
                m = maps_numbers(got, want)
                add({"chain_bev_median_gap": m["bev_median_gap"],
                     "chain_cls_p99_gap": m["cls_p99_gap"]})
        else:
            add({"chain_bev_median_gap": float("inf"), "chain_cls_p99_gap": float("inf")})
    return total


def failed(session) -> int:
    """Calls whose rows are not all finite."""
    return session.outputs["bad"]
