"""The port's offset-statistics tool (``tools/offset_stats.py``: forward hooks
on the offset/mask convs) against the JAX tool's method (the DCN offsets the
flax model sows as intermediates, ``tools/offset_stats.py``) on the same
weights: the narrow model of ``test_torch_slice.py`` with perturbed offset
convs, two batches at 64x128.  Same layer names; each statistic within
2e-3 (both sides round to 4 decimals, and the f32 offsets differ by
summation order, about 1e-6); then the tool's entry point on a saved
checkpoint prints the JAX tool's lines.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monoflex_tpu_torch.data.synthetic import make_inference_batch, make_synthetic_kitti
from monoflex_tpu_torch.tools.offset_stats import layer_names, offset_rows
from monoflex_tpu_torch.train.checkpoint import Checkpointer
from monoflex_tpu_torch.train.solver import build_optimizer
from test_torch_slice import jax_narrow_model, narrow_cfg, perturbed_port_model, to_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from offset_stats import flatten_intermediates  # noqa: E402  (the JAX tool)

sys.path.pop(0)
TOL = 2e-3


def jax_rows(cfg, params, stats, batches):
    """The JAX tool's rows, from the intermediates its ``capture`` reads."""
    model = jax_narrow_model(cfg)
    capture = jax.jit(lambda v, *a: model.apply(v, *a, train=False,
                                                mutable=["intermediates"])[1]["intermediates"])
    acc = {}
    for batch in batches:
        inter = jax.device_get(capture({"params": params, "batch_stats": stats},
                                       *(jnp.asarray(batch[k])
                                         for k in ("image", "edge_indices", "edge_len"))))
        for path, v in flatten_intermediates(inter).items():
            if "offset" in path:
                acc.setdefault(path.replace("/offset", ""), []).append(
                    np.abs(np.asarray(v)).ravel())
    R = cfg.TPU.DCN_MAX_OFFSET
    out = {}
    for layer in sorted(acc):
        v = np.concatenate(acc[layer])
        out[layer] = {"p50": np.percentile(v, 50), "p90": np.percentile(v, 90),
                      "p99": np.percentile(v, 99), "max": v.max(),
                      "frac_clipped": (v > R).mean(), "frac_gt_1": (v > 1.0).mean()}
    return out


def test_rows_match_the_jax_tool():
    cfg = narrow_cfg()
    model = perturbed_port_model(cfg, seed=31)
    params, stats = to_flax(model, cfg)
    batches = [make_inference_batch(2, 64, 128, seed=s) for s in (1, 2)]
    n, rows = offset_rows(cfg, model, batches, max_batches=2, device="cpu")
    want = jax_rows(cfg, params, stats, batches)
    assert n == 2 and [r["layer"] for r in rows] == list(want) and len(rows) == 16
    assert sorted(layer_names(cfg).values()) == list(want)
    for row in rows:
        for key, value in want[row["layer"]].items():
            assert abs(row[key] - float(value)) <= TOL, (row["layer"], key)
    assert max(r["frac_clipped"] for r in rows) > 0


def test_entry_point_prints_the_jax_lines(tmp_path):
    """On the CPU (MONOFLEX_PLATFORM=cpu), from a checkpoint the CLI's
    Checkpointer wrote, over a 1/4-scale synthetic tree."""
    from monoflex_tpu_torch.config import get_cfg_defaults
    from monoflex_tpu_torch.models.detector import build_model
    from monoflex_tpu_torch.train.train_step import TrainState

    make_synthetic_kitti(str(tmp_path / "kitti" / "training"), scale=4)
    opts = ["MODEL.HEAD.NUM_CHANNEL", "16", "INPUT.HEIGHT_TEST", "96", "INPUT.WIDTH_TEST", "320",
            "TEST.IMS_PER_BATCH", "2"]
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(REPO, "runs", "monoflex.yaml"))
    cfg.merge_from_list(opts)
    model = build_model(cfg, device="cpu", seed=1)
    optimizer, _, _ = build_optimizer(cfg, model)
    path = Checkpointer(str(tmp_path / "ckpt")).save("model_final", model, optimizer,
                                                      TrainState())
    env = {**os.environ, "MONOFLEX_PLATFORM": "cpu", "MONOFLEX_DATA_DIR": str(tmp_path),
           "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    r = subprocess.run([sys.executable, "-m", "monoflex_tpu_torch.tools.offset_stats",
                        "--config", "runs/monoflex.yaml", "--ckpt", path, "--max_batches", "1",
                        "--out", str(tmp_path / "rows.json"), *opts],
                       cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0] == "DCN |offset| stats over 1 batches (clamp R=2):"
    rows = [json.loads(line) for line in lines[1:]]
    assert len(rows) == 16 and rows == json.load(open(tmp_path / "rows.json"))
    assert list(rows[0]) == ["layer", "p50", "p90", "p99", "max", "frac_clipped", "frac_gt_1"]
    assert rows[0]["layer"] == "backbone/dla_up/ida_0/node_1/DCN_0"
