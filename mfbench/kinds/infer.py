"""The inference cells: the evaluation path's forward and decode, each
input uploaded and its rows copied back to the host, in a closed loop or
open at the mix's ``rate_hz``.

The model's BatchNorm statistics are worked out by the reference from the
cell's first input and handed to both sides (``weights.bn_statistics``);
their time is left out of ``setup_s``.  The check compares a sample of the
calls finished in the window, drawn from the seed, peak by peak with the
reference's forward and decode of the same inputs.
"""

from __future__ import annotations

import time
from typing import Dict, List

from mfbench.harness import sync, window


class DecodeTimer:
    """Wraps the decode so that CUDA events bracket each call (traced runs)."""

    def __init__(self):
        self.post = None
        self.pairs = []
        self.on = False

    def wrap(self, post):
        self.post = post
        return self

    def __call__(self, *args, **kw):
        if not self.on:
            return self.post(*args, **kw)
        import torch

        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.post(*args, **kw)
        b.record()
        self.pairs.append((a, b))
        return out

    def read_ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.pairs]


def prepare(session) -> None:
    """The BatchNorm statistics, through the reference, before the program
    is built; ``session.excluded_s`` takes their seconds.  The device, its
    libraries and their handles are brought up first, so that the time left
    out is the reference's own."""
    import torch
    import torch.nn.functional as F

    from mfbench.weights import bn_statistics

    device = session.device
    if torch.device(device).type == "cuda":
        x = torch.ones(1, 1, 4, 4, device=device)
        F.conv2d(x, torch.ones(1, 1, 3, 3, device=device))
        x.flatten()[None] @ x.flatten()[:, None]
        torch.cuda.synchronize()
    t0 = time.time()
    session.buffers = bn_statistics(session.tree, session.weights, session.args.seed, device,
                                    session.feed.pool[0])
    sync(device)
    session.excluded_s += time.time() - t0


def drive(session, prog, cfg, model) -> None:
    """Warm-up calls, then the window; keeps each call's rows and peaks (on
    the host) for the check in ``session.outputs``."""
    import torch

    from mfbench.faults import INFER

    run, feed, args = session.run, session.feed, session.args
    timer = DecodeTimer()
    eval_step = prog.eval_step(cfg, model, wrap=timer.wrap)
    for name in session.faults:
        eval_step = INFER[name](eval_step)
    kept: Dict[int, tuple] = {}
    spans = run.spans

    def call(i):
        host = feed.next(i)
        with spans("upload"):
            batch = prog.to_device(host, session.device)
        with spans("forward_decode"):
            rows, valid, extras = eval_step(batch)
        with spans("rows_to_host"):
            kept[i] = (i % len(feed.pool), rows.cpu(), extras["points"].cpu())

    for i in range(int(session.cell.traffic["warmup_calls"])):
        call(i)
    kept.clear()
    spans.items.clear()
    sync(session.device)
    run.setup_s = time.time() - args.process_start - session.excluded_s
    timer.on = session.trace_seconds > 0 and torch.device(session.device).type == "cuda"

    def trace_stopped():
        timer.on = False

    window(run, call, args.seconds, session.trace_seconds, session.device,
           rate_hz=float(session.cell.traffic.get("rate_hz", 0.0)), on_trace_stop=trace_stopped)
    if timer.pairs:
        sync(session.device)
        run.decode_ms = timer.read_ms()
    session.outputs = kept


def judge(session, precision: str = "stated") -> Dict[str, float]:
    """The inference numbers of a sample of the kept calls, drawn from the
    seed, against the reference; with ``precision``, of the control's own
    forward and decode of the same inputs."""
    import numpy as np
    import torch

    from mfbench import check
    from mfbench.reference import model as ref
    from mfbench.weights import load_buffers

    cell, kept, feed = session.cell, session.outputs, session.feed
    tree, weights, seed, device = session.tree, session.weights, session.args.seed, session.device
    if not kept:
        return {k: float("inf") for k in cell.limits["limits"]}
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    order = sorted(kept)
    take = sorted(rng.choice(order, size=min(len(order), int(cell.traffic["check_calls"])),
                             replace=False).tolist())
    model, _ = ref.build(tree, weights, seed, device)
    load_buffers(model, session.buffers)
    model.eval()
    control = None
    if precision != "stated":
        control, _ = ref.build(tree, weights, seed, device, precision)
        load_buffers(control, session.buffers)
        control.eval()
        ref.set_precision("stated")
    post = ref.decoder(tree)
    worst: Dict[str, float] = {}
    ori_margin = float(cell.limits["ori_margin"])
    for i in take:
        pool_index, rows, points = kept[i]
        batch = ref.upload(feed.pool[pool_index], device)
        with torch.no_grad():
            if control is not None:
                ref.set_precision(precision)
                out = control(batch["image"], batch["edge_indices"], batch["edge_len"])
                rows, _, extras = post(out, batch)
                points = extras["points"]
                ref.set_precision("stated")
            pred = model(batch["image"], batch["edge_indices"], batch["edge_len"])
            got = check.infer_numbers(pred, post, batch, rows, points, ori_margin)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def failed(session) -> int:
    """Calls whose rows are not all finite."""
    import torch

    return sum(not bool(torch.isfinite(rows).all()) for _, rows, _ in session.outputs.values())
