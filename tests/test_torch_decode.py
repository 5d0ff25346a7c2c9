"""The port's decoder against the JAX PostProcessor on the same head maps, for
every depth mode.

The heatmap is crafted tie-free: each class has a lattice of 128 peaks with
distinct values, most above the background, and NMS suppresses every other
pixel, so both top-k stages see more than K distinct nonzero scores.  (jax.lax.top_k and
torch.topk order ties differently, and NMS leaves exact zeros.)

Tolerance: rows agree to 1e-4 abs + 1e-5 relative (float32 on both sides;
depths reach 100 and locations tens of metres).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.core import geometry_jax as GJ
from monoflex_tpu.decode.postprocessor import PostProcessor as JaxPostProcessor
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.core import geometry as G
from monoflex_tpu_torch.decode.postprocessor import PostProcessor

RUN_YAML = os.path.join(os.path.dirname(__file__), "..", "runs", "monoflex.yaml")
B, C, H, W = 2, 3, 16, 32
TOL = dict(atol=1e-4, rtol=1e-5)
DEPTH_MODES = ["direct", "keypoints_avg", "keypoints_center", "keypoints_02",
               "keypoints_13", "hard", "soft", "mean", "oracle"]


@pytest.fixture(scope="module")
def cfg():
    c = get_cfg_defaults()
    c.merge_from_file(RUN_YAML)
    return c


def crafted_heads(cfg, seed=0):
    """NHWC numpy head maps: tie-free heatmap, random regression maps."""
    rng = np.random.RandomState(seed)
    hm = rng.uniform(1e-9, 1e-8, (B, H, W, C)).astype(np.float32)
    n_peaks = B * C * (H // 2) * (W // 2)
    # distinct, and skewed low so that only some of the top K pass the
    # 0.2 score threshold
    peaks = rng.permutation(np.linspace(0.25, 0.95, n_peaks) ** 12).astype(np.float32)
    hm[:, ::2, ::2, :] = peaks.reshape(B, H // 2, W // 2, C)
    reg = []
    for group in cfg.MODEL.HEAD.REGRESSION_CHANNELS:
        for ch in group:
            reg.append((rng.randn(B, H, W, ch) * 0.5).astype(np.float32))
    return hm, reg


def camera_batch(seed=1):
    rng = np.random.RandomState(seed)
    calib = np.array([[721.5, 721.5, 64.0, 32.0, 0.06, 0.0],
                      [700.0, 705.0, 60.0, 30.0, -0.3, 0.005]], np.float32)
    return {"calib_params": calib,
            "pad_size": np.array([[4.0, 2.0], [0.0, 6.0]], np.float32),
            "img_size": np.array([[128.0, 64.0], [120.0, 60.0]], np.float32),
            "_rng": rng}


def add_ground_truth(batch, rows, M=6):
    """Oracle fields: per image, GT boxes near the first predictions (same
    class, IoU > 0.5) and a few unmatched ones, with random depths."""
    rng = batch.pop("_rng")
    boxes = np.zeros((B, M, 4), np.float32)
    cls_ids = np.zeros((B, M), np.int32)
    locs = np.zeros((B, M, 3), np.float32)
    for b in range(B):
        for i in range(M):
            if i < 4:
                boxes[b, i] = rows[b, i, 2:6] + rng.uniform(-0.5, 0.5, 4)
                cls_ids[b, i] = int(rows[b, i, 0])
            else:
                x, y = rng.uniform(0, 100), rng.uniform(0, 50)
                boxes[b, i] = (x, y, x + 10, y + 8)
                cls_ids[b, i] = rng.randint(0, C)
            locs[b, i] = (rng.uniform(-5, 5), 1.5, rng.uniform(5, 60))
    reg_mask = np.ones((B, M), np.float32)
    reg_mask[:, -1] = 0
    batch.update(gt_bboxes=boxes, cls_ids=cls_ids, locations=locs, reg_mask=reg_mask)
    return batch


@pytest.fixture(scope="module")
def decoded(cfg):
    hm, reg = crafted_heads(cfg)
    batch = camera_batch()
    jpost, post = JaxPostProcessor(cfg), PostProcessor(cfg)
    jpred = {"cls": jnp.asarray(hm), "reg": tuple(jnp.asarray(r) for r in reg)}
    pred = {"cls": torch.from_numpy(hm).permute(0, 3, 1, 2),
            "reg": tuple(torch.from_numpy(r).permute(0, 3, 1, 2) for r in reg)}
    first, _, _ = jpost(jpred, {k: jnp.asarray(v) for k, v in batch.items() if k != "_rng"},
                        output_depth="direct")
    batch = add_ground_truth(batch, np.asarray(first))
    out = {}
    for mode in DEPTH_MODES:
        jrows, jvalid, _ = jpost(jpred, {k: jnp.asarray(v) for k, v in batch.items()},
                                 output_depth=mode)
        rows, valid, _ = post(pred, {k: torch.from_numpy(v) for k, v in batch.items()},
                              output_depth=mode)
        out[mode] = (np.asarray(jrows), np.asarray(jvalid), rows.numpy(), valid.numpy())
    return out


@pytest.mark.parametrize("mode", DEPTH_MODES)
def test_rows_match_jax(decoded, mode):
    jrows, jvalid, rows, valid = decoded[mode]
    assert rows.shape == (B, 50, 14)
    np.testing.assert_allclose(rows, jrows, **TOL)
    np.testing.assert_array_equal(valid, jvalid)
    assert 0 < valid.sum() < valid.size


def test_oracle_uses_both_branches(decoded):
    """Matched rows take one estimator's depth, unmatched ones the mean: the
    oracle differs from the plain mean on some rows but not on all."""
    oracle, mean = decoded["oracle"][2], decoded["mean"][2]
    same = np.isclose(oracle[..., 11], mean[..., 11])
    assert same.any() and not same.all()


@pytest.mark.parametrize("mode", ["exp", "linear", "inv_sigmoid"])
def test_decode_depth_modes(mode):
    x = np.linspace(-6, 6, 41).astype(np.float32)
    np.testing.assert_allclose(G.decode_depth(torch.from_numpy(x), mode).numpy(),
                               np.asarray(GJ.decode_depth(jnp.asarray(x), mode)), **TOL)


def test_box_nms_is_not_served(cfg):
    """TEST.USE_NMS was refused before ``decode/nms.py`` was ported; now the
    post-processor applies box NMS, 2d and 3d, and its validity mask equals
    the JAX one's and drops some of the rows the score threshold kept."""
    hm, reg = crafted_heads(cfg, seed=2)
    reg[0] = np.abs(reg[0]) * 8       # 2d_dim: boxes wide enough to overlap
    batch = {k: v for k, v in camera_batch().items() if k != "_rng"}
    jpred = {"cls": jnp.asarray(hm), "reg": tuple(jnp.asarray(r) for r in reg)}
    pred = {"cls": torch.from_numpy(hm).permute(0, 3, 1, 2),
            "reg": tuple(torch.from_numpy(r).permute(0, 3, 1, 2) for r in reg)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    kept = PostProcessor(cfg)(pred, tbatch)[1].sum()
    for use_nms in ("2d", "3d"):
        c = cfg.clone()
        c.TEST.USE_NMS = use_nms
        c.TEST.NMS_THRESH = 0.1
        jrows, jvalid, _ = JaxPostProcessor(c)(jpred, {k: jnp.asarray(v) for k, v in batch.items()})
        rows, valid, _ = PostProcessor(c)(pred, tbatch)
        np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), **TOL)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid), err_msg=use_nms)
        assert 0 < valid.sum() < kept, use_nms
