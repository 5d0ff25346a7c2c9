"""The readings a cell's limits are set from, in one process on the card:

    python3 mfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--control N] [--faults half_batch,alter_answer] [--fault-seeds N] [--offsets]

For each seed it makes a run of the cell (set-up as the benchmark makes it,
then a window of ``--seconds``) and prints one JSON line with the numbers
the check compares: the program against the reference ("program"); on the
first ``--control`` seeds also the configuration's control against the
reference ("control": TF32 for a float32 configuration, float8 for a
bfloat16 one, ``reference/model.py``); on the first ``--fault-seeds``
seeds each planted fault of ``--faults`` (``faults.py``) against the
reference.  ``--offsets`` adds, on the first seed, the percentiles of
|offset| by DCN layer that the weights give the reference on the cell's
first input.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    __package__ = "mfbench"

from mfbench.harness import Session, process_start, require_cards, set_environment  # noqa: E402


def offsets(session: Session) -> list:
    """p50, p90 and p99 of |offset| (px) of each DCN layer of the f32
    reference, on the cell's first input (eval mode for inference cells,
    train mode for training cells)."""
    import torch

    from mfbench.reference import model as ref
    from mfbench.reference.dla import DCN
    from mfbench.weights import load_buffers

    model, _ = ref.build(session.tree, session.weights, session.args.seed, session.device)
    if session.buffers:
        load_buffers(model, session.buffers)
    model.train(session.kind == "train")
    rows = []

    def hook(mod, args, out):
        off = out.float()[:, :18].abs().flatten()
        q = torch.quantile(off[:: max(1, off.numel() // 1_000_000)],
                           torch.tensor([0.5, 0.9, 0.99], device=off.device))
        rows.append([round(float(v), 4) for v in q])

    names = [(n, m) for n, m in model.named_modules() if isinstance(m, DCN)]
    hs = [m.conv_offset_mask.register_forward_hook(hook) for _, m in names]
    first = session.feed.pool[0] if session.feed.pool else session.outputs["batches"][0]
    x = ref.upload(first, session.device)
    with torch.no_grad():
        model(x["image"], x.get("edge_indices"), x.get("edge_len"))
    for h in hs:
        h.remove()
    return [[n] + r for (n, _), r in zip(names, rows)]


def main(argv=None, device=None, overrides=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--offsets", action="store_true")
    a = ap.parse_args(argv)
    set_environment()
    faults = [f for f in a.faults.split(",") if f]
    for k, seed in enumerate(int(s) for s in a.seeds.split(",")):
        for fault in [None] + (faults if k < a.fault_seeds else []):
            args = argparse.Namespace(workload=a.workload, seed=seed, seconds=a.seconds,
                                      trace=0, process_start=process_start())
            session = Session(args, device or "cuda", overrides, [fault] if fault else None)
            if device is None:
                require_cards(session.cell.chips, a.workload)
            t0 = time.time()
            line = {"cell": a.workload, "seed": seed, "variant": fault or "program"}
            try:
                session.measure()
                line["calls"] = session.run.calls
                line["numbers"] = session.judge()
                if fault is None and k < a.control:
                    line["control"] = session.judge(session.cell.config["control"])
                if fault is None and a.offsets and k == 0:
                    line["offsets"] = offsets(session)
            finally:
                session.close()
            line["seconds"] = time.time() - t0
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
