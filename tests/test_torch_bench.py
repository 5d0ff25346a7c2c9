"""The port's benchmark entry points against the JAX package's: the timed
function of ``monoflex_tpu_torch/bench.py`` and ``entry()``'s ``fn`` (the
forward and the decode) against ``bench.py``'s ``infer`` and
``__graft_entry__.py``'s ``forward`` (``model.apply(train=False)`` then the
``PostProcessor``) on the same seeded uint8 batch and the same weights; the
BENCH_* knobs against the config keys ``bench.py:62-81`` sets; and the
command line without a card.

The model is the narrow one of ``test_torch_slice.py`` (64x128, batch 2),
its weights perturbed as there and sent to flax through the JAX package's
importer and back through the port's bridge, its heatmap spread over (0, 1)
as in ``test_torch_eval_slice.py`` so that few peaks are near-tied.  The
JAX side runs the clamped DCN as the XLA shift op, the port its kernel
wrapper (the plain op on the CPU), both with f32 x (pallas3).

Tolerance: the decoded rows within the eval slice's 1e-4 abs + 1e-5
relative (the slice's ATOL; depths reach tens of metres).  Rows are matched
by class and nearest row: near-tied peaks may leave ``torch.topk`` and
``jax.lax.top_k`` in another order, and at most 2 rows an image may have no
partner (the 50th peak swapped with the 51st).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.config import get_cfg_defaults as jax_cfg_defaults
from monoflex_tpu.decode.postprocessor import PostProcessor as JaxPostProcessor
from monoflex_tpu.models.backbone.dla import resolve_dcn_stages as jax_resolve_dcn_stages
from monoflex_tpu_torch import bench
from monoflex_tpu_torch.data.synthetic import make_inference_batch
from monoflex_tpu_torch.entry import dryrun_multichip, entry
from monoflex_tpu_torch.models.backbone.dla import resolve_dcn_stages
from monoflex_tpu_torch.parallel import dryrun
from monoflex_tpu_torch.utils.param_bridge import load_flax_variables
from test_torch_eval_slice import ROW_TOL, spread_heatmap
from test_torch_slice import B, H, STAGE_R, W, jax_narrow_model, perturbed_port_model, \
    port_narrow_model, to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_UNMATCHED = 2


def narrow(cfg):
    cfg.MODEL.HEAD.NUM_CHANNEL = 16
    cfg.TPU.DCN_FORCE_IMPL = "pallas3"
    cfg.TPU.DCN_MAX_OFFSET_PER_STAGE = STAGE_R
    cfg.INPUT.HEIGHT_TEST, cfg.INPUT.WIDTH_TEST = H, W
    cfg.TEST.DETECTIONS_THRESHOLD = 0.85       # rows on both sides of it
    return cfg


def jax_bench_cfg(env):
    """``bench.py:60-81``: runs/monoflex.yaml and the knobs, in the JAX config."""
    cfg = jax_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
    impl = env.get("BENCH_DCN_IMPL")
    if impl == "shift":
        cfg.TPU.USE_PALLAS_DCN = False
    elif impl == "gather":
        cfg.TPU.USE_PALLAS_DCN = False
        cfg.MODEL.BACKBONE.CONV_BODY = "dla34"
    if env.get("BENCH_KERNEL_VERSION"):
        cfg.TPU.DCN_KERNEL_VERSION = int(env["BENCH_KERNEL_VERSION"])
    if env.get("BENCH_IMPL_PER_STAGE"):
        cfg.TPU.DCN_IMPL_PER_STAGE = tuple(env["BENCH_IMPL_PER_STAGE"].split(","))
    if env.get("BENCH_DTYPE"):
        cfg.TPU.COMPUTE_DTYPE = env["BENCH_DTYPE"]
    if env.get("BENCH_FUSE_BN_RELU"):
        cfg.TPU.DCN_FUSE_BN_RELU = env["BENCH_FUSE_BN_RELU"] == "1"
    return cfg


@pytest.fixture(scope="module")
def sides():
    """The JAX rows, and the port's model, post-processor config and batch."""
    cfg = narrow(bench.bench_config({}))
    source = spread_heatmap(perturbed_port_model(cfg))
    params, stats = to_flax(source, cfg)
    model = port_narrow_model(cfg)
    load_flax_variables(model, params, stats, cfg)

    batch = make_inference_batch(B, H, W)
    jmodel, jpost = jax_narrow_model(cfg), JaxPostProcessor(narrow(jax_bench_cfg({})))

    @jax.jit
    def jax_infer(variables, batch):
        out = jmodel.apply(variables, batch["image"], batch["edge_indices"], batch["edge_len"],
                           train=False)
        result, valid, _ = jpost(out, batch)
        return result, valid

    jrows, jvalid = jax_infer({"params": params, "batch_stats": stats},
                              {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return dict(cfg=cfg, model=model, batch=tbatch, jrows=np.asarray(jrows),
                jvalid=np.asarray(jvalid))


def assert_rows_match(rows, valid, jrows, jvalid):
    """Per image, every row has the JAX row of its class nearest to it within
    the tolerance (but for MAX_UNMATCHED), the valid rows among them."""
    assert rows.shape == jrows.shape == (B, 50, 14)
    n_valid = 0
    for r, v, jr, jv in zip(rows, valid, jrows, jvalid):
        unmatched = 0
        for row, ok in zip(r, v):
            same = np.flatnonzero(jr[:, 0] == row[0])
            err = np.abs(jr[same] - row).max(axis=1) if len(same) else np.array([np.inf])
            j = same[err.argmin()] if len(same) else None
            if j is None or not np.allclose(row, jr[j], **ROW_TOL):
                unmatched += 1
                continue
            assert bool(ok) == bool(jv[j]), (row, jr[j])
            n_valid += int(ok)
        assert unmatched <= MAX_UNMATCHED
        assert abs(int(v.sum()) - int(jv.sum())) <= MAX_UNMATCHED
    return n_valid


@pytest.mark.parametrize("entry_point", ["bench", "entry"])
def test_timed_function_matches_jax_infer(sides, entry_point):
    if entry_point == "bench":
        fn = lambda model, batch: bench.infer(model, bench.PostProcessor(sides["cfg"]), batch)
    else:
        fn, (model, batch) = entry(device="cpu", cfg=sides["cfg"], batch_size=B)
        assert batch["image"].dtype == torch.uint8 and batch["image"].shape == (B, H, W, 3)
        assert not model.training
        # the example batch is the benchmark's batch
        for k, v in batch.items():
            assert torch.equal(v, sides["batch"][k]), k
    rows, valid = fn(sides["model"], sides["batch"])
    assert rows.dtype == torch.float32 and torch.isfinite(rows).all()
    n_valid = assert_rows_match(rows.numpy(), valid.numpy(), sides["jrows"], sides["jvalid"])
    assert 0 < n_valid < B * 50


def test_entry_defaults_to_the_card_and_the_bench_config():
    """entry() builds on the card at batch 8, 384x1280, unless told otherwise;
    dryrun_multichip is parallel/dryrun.py's."""
    import inspect

    params = inspect.signature(entry).parameters
    assert params["device"].default == "cuda" and params["batch_size"].default == 8
    assert all(p.kind == p.KEYWORD_ONLY for p in params.values())
    cfg = bench.bench_config({})
    assert (cfg.INPUT.HEIGHT_TEST, cfg.INPUT.WIDTH_TEST) == (384, 1280)
    assert dryrun_multichip is dryrun.dryrun_multichip


KNOBS = [
    ({}, ("pallas3b",) * 4),
    ({"BENCH_DCN_IMPL": "shift"}, ("shift",) * 4),
    ({"BENCH_DCN_IMPL": "gather"}, ("gather",) * 4),
    ({"BENCH_KERNEL_VERSION": "1"}, ("pallas",) * 4),
    ({"BENCH_KERNEL_VERSION": "2"}, ("pallas2",) * 4),
    ({"BENCH_IMPL_PER_STAGE": "gather,gather,pallas2,pallas2"},
     ("gather", "gather", "pallas2", "pallas2")),
    ({"BENCH_DTYPE": "bfloat16"}, ("pallas3b",) * 4),
    ({"BENCH_FUSE_BN_RELU": "1"}, ("pallas3b",) * 4),
    ({"BENCH_FUSE_BN_RELU": "0"}, ("pallas3b",) * 4),
]
KEYS = ("TPU.USE_PALLAS_DCN", "MODEL.BACKBONE.CONV_BODY", "TPU.DCN_KERNEL_VERSION",
        "TPU.DCN_IMPL_PER_STAGE", "TPU.COMPUTE_DTYPE", "TPU.DCN_FUSE_BN_RELU")


def key(cfg, name):
    for part in name.split("."):
        cfg = getattr(cfg, part)
    return tuple(cfg) if isinstance(cfg, (list, tuple)) else cfg


@pytest.mark.parametrize("env,impls", KNOBS, ids=[json.dumps(e) for e, _ in KNOBS])
def test_knobs_set_the_jax_bench_keys(env, impls):
    """Each knob sets the keys bench.py sets, and the neck resolves to the
    impls the TPU's resolution gives them; "gather" names its impl, since
    the JAX package gets it from its off-TPU default (on the CPU here its
    resolution of the same keys gives it too)."""
    cfg, jcfg = bench.bench_config(env), jax_bench_cfg(env)
    assert {k: key(cfg, k) for k in KEYS} == {k: key(jcfg, k) for k in KEYS}
    assert resolve_dcn_stages(cfg)[0] == impls
    if env.get("BENCH_DCN_IMPL") == "gather":
        assert cfg.TPU.DCN_FORCE_IMPL == "gather"
        assert jax_resolve_dcn_stages(jcfg)[0] == impls
    else:
        assert cfg.TPU.DCN_FORCE_IMPL == jcfg.TPU.DCN_FORCE_IMPL == ""


def test_bench_without_a_card_prints_the_error_line():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "monoflex_tpu_torch.bench"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["metric"] == "inference_images_per_sec_per_chip"
    assert last["value"] is None and last["vs_baseline"] is None and last["unit"] == "img/s"
    assert "no CUDA device" in last["error"]


def test_result_line_has_the_jax_keys():
    line = json.loads(bench.result_line(bench.METRIC, 160, 1.5, bench.V100_BASELINE_IMG_PER_S))
    assert line == {"metric": "inference_images_per_sec_per_chip", "value": 106.67,
                    "unit": "img/s", "vs_baseline": 3.232}
