"""The evaluation path as a whole: a KITTI-format tree (1/4 scale, 5 frames,
split trainval) through the reader, the padded test loader, the narrow model
of ``test_torch_slice.py`` at 96x320, the decode, the KITTI writer and the
official evaluator, the port's ``engine.inference`` against the JAX
package's on the same weights (flax variables through the port's bridge).

- Decoded rows, batch by batch (3 images, the last batch padded): 1e-4 abs +
  1e-5 relative (float32 both sides; depths reach 100 and locations tens of
  metres).  Rows are matched by (image, class, peak location): at random
  weights most of the 50 peaks have scores near 1e-5, and near-ties among
  them may leave ``torch.topk`` and ``jax.lax.top_k`` in another order (or
  swap the 50th peak).  The rows above the score threshold must be the same
  set.
- The txt files ``inference()`` writes: the same files, lines and classes,
  the numbers within 2e-4 abs + 1e-5 relative (the rows' tolerance plus the
  writer's 6 decimals), lines sorted by class and box.
- The AP dicts: equal keys, values within 1e-6 (points): the same
  detections up to that rounding, and the same evaluator code (the JAX one's
  optional C++ path is turned off, since the port has only the numpy one).
- Two depth modes of ``inference_all_depths``, the same three ways.
"""

import os

import jax
import numpy as np
import pytest
import torch

import monoflex_tpu.native
from monoflex_tpu.config import get_cfg_defaults as jax_cfg_defaults
from monoflex_tpu.data.dataset import KITTIDataset as JaxKITTIDataset
from monoflex_tpu.data.loader import make_test_loader as jax_make_test_loader
from monoflex_tpu.decode.postprocessor import PostProcessor as JaxPostProcessor
from monoflex_tpu.engine.inference import inference as jax_inference
from monoflex_tpu.engine.inference import inference_all_depths as jax_inference_all_depths
from monoflex_tpu.train.train_step import TrainState as JaxTrainState
from monoflex_tpu.train.train_step import make_eval_step as jax_make_eval_step
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.dataset import KITTIDataset
from monoflex_tpu_torch.data.loader import make_test_loader
from monoflex_tpu_torch.decode.postprocessor import PostProcessor
from monoflex_tpu_torch.engine.inference import inference, inference_all_depths, to_device
from monoflex_tpu_torch.train.train_step import make_eval_step
from monoflex_tpu_torch.utils.param_bridge import load_flax_variables
from synthetic_kitti import make_synthetic_kitti
from test_torch_slice import (RUN_YAML, STAGE_R, jax_narrow_model, perturbed_port_model,
                              port_narrow_model, to_flax)

ROW_TOL = dict(atol=1e-4, rtol=1e-5)
TXT_TOL = dict(atol=2e-4, rtol=1e-5)
AP_ATOL = 1e-6
OPTS = ["MODEL.HEAD.NUM_CHANNEL", 16, "TPU.DCN_FORCE_IMPL", "pallas3",
        "TPU.DCN_MAX_OFFSET_PER_STAGE", STAGE_R, "INPUT.HEIGHT_TEST", 96, "INPUT.WIDTH_TEST", 320,
        "DATASETS.TEST_SPLIT", "trainval", "TEST.IMS_PER_BATCH", 3,
        "TEST.DETECTIONS_THRESHOLD", 0.85, "DATALOADER.NUM_WORKERS", 2,
        "TEST.EVAL_DEPTH_METHODS", ["soft", "oracle"]]


def make_cfg(defaults):
    cfg = defaults()
    cfg.merge_from_file(RUN_YAML)
    cfg.merge_from_list(list(OPTS))
    return cfg


@torch.no_grad()
def spread_heatmap(model):
    """At init the class head's prior bias holds every heatmap value near
    0.01, 1e-5 apart; a larger output conv spreads the peaks over (0, 1)."""
    out = model.heads["predictor"].class_head[2]
    out.weight.mul_(40)
    out.bias.copy_(torch.tensor([-1.0, -1.5, -2.0]))
    return model


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(port, jax): each a dict of cfg, dataset, eval step (and its state)."""
    root = make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti") / "training"), scale=4,
                                n_random_frames=2, render=True)
    cfg, jcfg = make_cfg(get_cfg_defaults), make_cfg(jax_cfg_defaults)
    params, stats = to_flax(spread_heatmap(perturbed_port_model(cfg)), cfg)
    model = port_narrow_model(cfg)
    load_flax_variables(model, params, stats, cfg)
    jstate = JaxTrainState(step=0, params=params, batch_stats=stats, opt_state=None, skips=0)
    jitted = jax.jit(jax_make_eval_step(jax_narrow_model(cfg), JaxPostProcessor(jcfg)),
                     static_argnames="output_depth")

    def jstep(state, batch, output_depth=None):
        # None is the config's mode ("soft"): one compile serves both
        return jitted(state, batch, output_depth=output_depth or cfg.MODEL.HEAD.OUTPUT_DEPTH)

    port = dict(cfg=cfg, dataset=KITTIDataset(cfg, root, is_train=False),
                step=make_eval_step(model, PostProcessor(cfg)))
    jax_side = dict(cfg=jcfg, dataset=JaxKITTIDataset(jcfg, root, is_train=False), step=jstep,
                    state=jstate)
    return port, jax_side


def test_decoded_rows_match_jax(sides):
    port, jx = sides
    batches = list(zip(make_test_loader(port["cfg"], port["dataset"]),
                       jax_make_test_loader(jx["cfg"], jx["dataset"])))
    assert len(batches) == 2 and batches[-1][0]["image_id"][-1] == -1
    n_valid = 0
    for batch, jbatch in batches:
        rows, valid, extras = port["step"](to_device(batch, "cpu"))
        jrows, jvalid, jextras = jx["step"](jx["state"], jbatch)
        ours = keyed_rows(rows.numpy(), valid.numpy(), extras["points"].numpy())
        theirs = keyed_rows(np.asarray(jrows), np.asarray(jvalid), np.asarray(jextras["points"]))
        for (by_key, valid_keys), (jby_key, jvalid_keys) in zip(ours, theirs):
            common = by_key.keys() & jby_key.keys()
            assert len(common) >= len(by_key) - 2
            assert valid_keys == jvalid_keys
            for key in common:
                np.testing.assert_allclose(by_key[key], jby_key[key], err_msg=str(key), **ROW_TOL)
            n_valid += len(valid_keys)
    assert 0 < n_valid < 6 * 50


def keyed_rows(rows, valid, points):
    """Per image: ({(class, x, y): row}, {keys of the rows above threshold})."""
    out = []
    for r, v, p in zip(rows, valid, points):
        keys = [(int(row[0]), int(x), int(y)) for row, (x, y) in zip(r, p)]
        out.append((dict(zip(keys, r)), {k for k, ok in zip(keys, v) if ok}))
    return out


def read_txts(pred_dir):
    out = {}
    for name in sorted(os.listdir(pred_dir)):
        lines = sorted(([ln.split() for ln in open(os.path.join(pred_dir, name))]),
                       key=lambda ln: (ln[0], round(float(ln[4]), 1), round(float(ln[5]), 1)))
        out[name] = ([ln[0] for ln in lines], np.array([ln[1:] for ln in lines], np.float64))
    return out


def assert_runs_match(ours, theirs, pred_dir, jpred_dir):
    txts, jtxts = read_txts(pred_dir), read_txts(jpred_dir)
    assert txts.keys() == jtxts.keys() and len(txts) == 5
    for name, (classes, values) in txts.items():
        assert classes == jtxts[name][0], name
        np.testing.assert_allclose(values, jtxts[name][1], err_msg=name, **TXT_TOL)
    assert sum(len(c) for c, _ in txts.values()) > 0
    keys = sorted(k for k in ours if k != "s_per_img")
    assert keys == sorted(k for k in theirs if k != "s_per_img") and len(keys) == 55
    for key in keys:
        np.testing.assert_allclose(float(ours[key]), float(theirs[key]), atol=AP_ATOL,
                                   err_msg=key)


@pytest.fixture
def numpy_evaluator(monkeypatch):
    monkeypatch.setattr(monoflex_tpu.native, "load_native", lambda: None)


def test_inference_matches_jax(sides, tmp_path, numpy_evaluator):
    port, jx = sides
    ours = inference(port["cfg"], port["step"], port["dataset"], str(tmp_path / "port"),
                     device="cpu")
    theirs = jax_inference(jx["cfg"], jx["step"], jx["state"], jx["dataset"],
                           str(tmp_path / "jax"))
    assert ours["images"] == theirs["images"] == 6
    assert_runs_match(ours, theirs, str(tmp_path / "port" / "data"),
                      str(tmp_path / "jax" / "data"))


def test_depth_sweep_matches_jax(sides, tmp_path, numpy_evaluator):
    port, jx = sides
    ours = inference_all_depths(port["cfg"], port["step"], port["dataset"],
                                str(tmp_path / "port"), device="cpu")
    theirs = jax_inference_all_depths(jx["cfg"], jx["step"], jx["state"], jx["dataset"],
                                      str(tmp_path / "jax"))
    assert list(ours) == list(theirs) == ["soft", "oracle"]
    for mode in ours:
        assert_runs_match(ours[mode], theirs[mode],
                          str(tmp_path / "port" / f"depth_{mode}" / "data"),
                          str(tmp_path / "jax" / f"depth_{mode}" / "data"))
    assert not np.allclose(read_txts(str(tmp_path / "port" / "depth_soft" / "data"))
                           ["000000.txt"][1], read_txts(str(tmp_path / "port" / "depth_oracle"
                                                            / "data"))["000000.txt"][1])


def test_visualize_is_not_served(sides, tmp_path):
    port, _ = sides
    with pytest.raises(NotImplementedError, match="visualizer"):
        inference(port["cfg"], port["step"], port["dataset"], str(tmp_path), visualize=True,
                  device="cpu")


def test_entry_points_default_to_the_card():
    import inspect

    from monoflex_tpu_torch.engine import test_net
    from monoflex_tpu_torch.models.detector import build_model

    for fn in (build_model, inference, inference_all_depths, test_net.run_test):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
