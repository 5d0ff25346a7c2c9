"""Learned DCN offset distributions per neck layer (counterpart of the JAX
package's ``tools/offset_stats.py``, with its flags and output lines).

The clamped DCN impls clamp the learned offsets to +-R feature pixels
(``TPU.DCN_MAX_OFFSET``) where the reference CUDA op is unbounded.  This
tool runs a checkpoint over a dataset, reads every DCN's offsets with a
forward hook on its offset/mask conv (channels 0-17 of its output, the
offsets the JAX model sows), and prints per layer the |offset| percentiles
and the share that the clamp saturates.  Layers carry the JAX names
(``backbone/dla_up/ida_0/proj_1/DCN_0``)::

    MONOFLEX_DATA_DIR=output/conv_data python -m monoflex_tpu_torch.tools.offset_stats \\
        --config runs/monoflex.yaml --ckpt output/conv_run/ckpt/model_final \\
        --max_batches 8 INPUT.HEIGHT_TEST 96 INPUT.WIDTH_TEST 320

It runs on the card and exits non-zero without one; ``MONOFLEX_PLATFORM=cpu``
runs it on the CPU, as the CLI.  ``--ckpt`` takes the port's checkpoints and
converted JAX ones (``convert_jax_checkpoint.py``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..utils.param_bridge import name_map

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def layer_names(cfg) -> Dict[str, str]:
    """{the port's DCN module name: the JAX layer name} from the parameter
    bridge's map of each offset/mask conv."""
    suffix = ".conv_offset_mask.weight"
    return {torch_name[:-len(suffix)]: flax_path[:-len("/Conv_0/kernel")]
            for torch_name, flax_path in name_map(cfg).items() if torch_name.endswith(suffix)}


def offset_rows(cfg, model: torch.nn.Module, loader, max_batches: int, device) -> tuple:
    """(batches read, one row a DCN layer: |offset| p50/p90/p99/max, the
    share beyond R and beyond 1 pixel), as the JAX tool computes them."""
    from ..engine.inference import to_device
    from ..models.backbone.dla import DCN

    names = layer_names(cfg)
    acc: Dict[str, List[np.ndarray]] = {}

    def hook(layer):
        def record(_module, _inputs, out):
            acc.setdefault(layer, []).append(out[:, :18].float().abs().flatten().cpu().numpy())
        return record

    handles = [m.conv_offset_mask.register_forward_hook(hook(names[n]))
               for n, m in model.named_modules() if isinstance(m, DCN)]
    n = 0
    model.eval()
    try:
        with torch.inference_mode():
            for batch in loader:
                if n >= max_batches:
                    break
                batch = to_device(batch, device)
                model(batch["image"], batch.get("edge_indices"), batch.get("edge_len"))
                n += 1
    finally:
        for h in handles:
            h.remove()
    R = cfg.TPU.DCN_MAX_OFFSET
    rows = []
    for layer in sorted(acc):
        v = np.concatenate(acc[layer])
        rows.append({
            "layer": layer,
            "p50": round(float(np.percentile(v, 50)), 4),
            "p90": round(float(np.percentile(v, 90)), 4),
            "p99": round(float(np.percentile(v, 99)), 4),
            "max": round(float(v.max()), 4),
            "frac_clipped": round(float((v > R).mean()), 6),
            "frac_gt_1": round(float((v > 1.0).mean()), 6),
        })
    return n, rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="runs/monoflex.yaml")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--max_batches", type=int, default=8)
    ap.add_argument("--out", default="")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    from ..cli import require_device, run_device
    from ..config import get_cfg_defaults
    from ..data.dataset import KITTIDataset
    from ..data.loader import make_test_loader
    from ..models.detector import build_model
    from ..train.checkpoint import Checkpointer
    from ..train.solver import build_optimizer

    require_device()
    device = run_device()
    cfg = get_cfg_defaults()
    cfg.merge_from_file(args.config)
    if args.opts:
        cfg.merge_from_list(args.opts)
    data_root = os.path.join(os.environ.get("MONOFLEX_DATA_DIR", "datasets"), "kitti",
                             "training")
    model = build_model(cfg, device=device)
    optimizer, _, _ = build_optimizer(cfg, model)
    Checkpointer(os.path.dirname(os.path.abspath(args.ckpt)), False).load(
        model, optimizer, args.ckpt)
    loader = make_test_loader(cfg, KITTIDataset(cfg, data_root, is_train=False))
    n, rows = offset_rows(cfg, model, loader, args.max_batches, device)
    print(f"DCN |offset| stats over {n} batches (clamp R={cfg.TPU.DCN_MAX_OFFSET}):")
    for r in rows:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    from . import write_launch_log

    write_launch_log()


if __name__ == "__main__":
    main()
