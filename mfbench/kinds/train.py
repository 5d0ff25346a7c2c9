"""The training cells: the program's training step with its optimizer, fed
by the cell's source, batch after batch in a closed loop.

Set-up builds the step once and drives it through its first
``check_steps`` steps, the same call and feed the window then drives; the
check compares those steps with the reference's from the same seed and
inputs.  In the first step the DCN calls at indices drawn from the seed are
recorded as the program's op receives and returns them (``DcnRecorder``),
so that the check can hold the kernels' backward to the plain one on the
very inputs they had.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Dict, List

import numpy as np
import torch

from mfbench.harness import sync, window

DCN_PICKS = 3          # DCN calls of the first step the check holds to the plain backward


def _keep(record: Dict, name: str, grad: torch.Tensor) -> None:
    record[name] = grad.detach().cpu()


class DcnRecorder:
    """Wraps the program's DCN op: at the calls ``picks`` (in forward order)
    it keeps, on the host, the operands as the op receives them (x, offset,
    mask, weight) and, as the backward passes, the output gradient g and the
    op's gradients of its operands (dx, doffset, dmask, dweight).  Each of
    those operands feeds this op alone, so its gradient is the op's own."""

    def __init__(self, picks):
        self.picks = {int(k) for k in picks}
        self.count = 0
        self.calls: Dict[int, Dict[str, torch.Tensor]] = {}

    def wrap(self, op):
        def call(x, offset, mask, weight, bias=None, **kw):
            k = self.count
            self.count += 1
            y = op(x, offset, mask, weight, bias, **kw)
            if k in self.picks and y.requires_grad:
                rec = self.calls[k] = {n: t.detach().cpu() for n, t in
                                       (("x", x), ("offset", offset), ("mask", mask),
                                        ("weight", weight))}
                for name, t in (("dx", x), ("doffset", offset), ("dmask", mask),
                                ("dweight", weight)):
                    if t.requires_grad:
                        t.register_hook(partial(_keep, rec, name))
                y.register_hook(partial(_keep, rec, "g"))
            return y
        return call


def dcn_picks(seed: int, n_layers: int) -> List[int]:
    rng = np.random.default_rng([int(seed) % 2 ** 64, 13])
    return sorted(rng.choice(n_layers, size=min(DCN_PICKS, n_layers), replace=False).tolist())


def drive(session, prog, cfg, model) -> None:
    """The first ``check_steps`` steps, recorded for the check, then the
    window; sets ``session.outputs`` (the record)."""
    from mfbench.faults import TRAIN
    from mfbench.reference.model import bn_stats, norms

    run, feed, args = session.run, session.feed, session.args
    step, optimizer = prog.train_step(cfg, model, feed.steps_per_epoch)
    for name in session.faults:
        step = TRAIN[name](step, optimizer)
    state = [prog.TrainState()]
    n_check = int(session.cell.traffic["check_steps"])
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    record = {"losses": [], "batches": []}
    recorder = DcnRecorder(dcn_picks(args.seed, len(session.cell.config["work"]["dcn_layers"])))
    for i in range(n_check):
        host = feed.next(i)
        record["batches"].append(host)
        undo = prog.wrap_dcn(recorder.wrap) if i == 0 else None
        try:
            state[0], metrics = step(state[0], prog.to_device(host, session.device))
        finally:
            if undo:
                undo()
        record["losses"].append(float(metrics["total_loss"]))
        if i == 0:
            beta1 = prog.adam_beta1(optimizer)
            record["grad_norms"] = norms({n: m / (1 - beta1) for n, m in
                                         prog.first_moments(optimizer, model).items()})
            record["bn_stats"] = bn_stats(model)
            record["dcn_calls"] = recorder.calls
    record["delta_norms"] = norms({n: p.detach() - start[n] for n, p in model.named_parameters()})
    del start

    spans = run.spans

    def call(i):
        with spans("data_wait"):
            host = feed.next(n_check + i)
        with spans("upload"):
            batch = prog.to_device(host, session.device)
        with spans("step"):
            state[0], metrics = step(state[0], batch)
        run.skipped += int(metrics["skipped"])

    sync(session.device)
    run.setup_s = time.time() - args.process_start - session.excluded_s
    window(run, call, args.seconds, session.trace_seconds, session.device)
    session.outputs = record


def judge(session, precision: str = "stated") -> Dict[str, float]:
    """The training numbers of the program's first steps against the
    reference's, or, with ``precision``, of the control's (the reference
    one precision step down, in the program's place)."""
    from mfbench import check
    from mfbench.reference import model as ref

    record, feed, a = session.outputs, session.feed, session.args
    tree, weights, device = session.tree, session.weights, session.device
    numbers: Dict[str, float] = {}
    batches = record["batches"]
    if feed.judge_batches is not None:
        batches, numbers = feed.judge_batches(record, tree)
    ref_record = ref.train_record(tree, weights, a.seed, device, batches, feed.steps_per_epoch)
    prog_record = record
    if precision != "stated":
        prog_record = ref.train_record(tree, weights, a.seed, device, batches,
                                       feed.steps_per_epoch, precision)
    numbers.update(check.train_numbers(prog_record, ref_record))
    numbers["dcn_grad_gap"] = check.dcn_grad_gap(record["dcn_calls"], ref_record["dcn_specs"],
                                                 device, precision)
    return numbers


def failed(session) -> int:
    """Steps the program skipped as not finite."""
    return session.run.skipped
