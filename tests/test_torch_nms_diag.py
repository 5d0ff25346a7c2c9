"""The port's box NMS and diagnostic evaluators against the JAX package's on
the same numpy inputs.

NMS: the surviving-validity masks must be equal (2d and 3d boxes, class-aware
and class-agnostic; scores are distinct, so the greedy order is the same).
Diagnostics: float32 on both sides; depth errors reach tens of metres, so
1e-4 abs + 1e-5 relative; the IoU means 1e-5 abs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.decode.diagnostics import DiagnosticEvaluator as JaxDiagnosticEvaluator
from monoflex_tpu.decode.nms import apply_nms as jax_apply_nms
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.synthetic import make_train_batch
from monoflex_tpu_torch.decode.diagnostics import DiagnosticEvaluator
from monoflex_tpu_torch.decode.nms import apply_nms

RUN_YAML = os.path.join(os.path.dirname(__file__), "..", "runs", "monoflex.yaml")
B, K = 3, 50
DEPTH_TOL = dict(atol=1e-4, rtol=1e-5)
IOU_TOL = dict(atol=1e-5, rtol=0)


def decode_rows(seed=0):
    """(B, K, 14) rows in the decoder's layout, with clustered boxes so that
    many overlap, distinct scores, and a validity mask."""
    rng = np.random.RandomState(seed)
    rows = np.zeros((B, K, 14), np.float32)
    rows[..., 0] = rng.randint(0, 3, (B, K))
    centers = rng.uniform(20, 200, (B, 6, 2))[:, rng.randint(0, 6, K)]     # 6 clusters
    xy = centers + rng.randn(B, K, 2) * 6
    wh = rng.uniform(10, 40, (B, K, 2))
    rows[..., 2:4] = xy - wh / 2
    rows[..., 4:6] = xy + wh / 2
    rows[..., 6:9] = rng.uniform(1, 4, (B, K, 3))                            # h, w, l
    rows[..., 9] = xy[..., 0] / 20 - 5                                       # x
    rows[..., 11] = xy[..., 1] / 10 + 5                                      # z
    rows[..., 13] = rng.permutation(B * K).reshape(B, K) / (B * K) + 0.01
    valid = rows[..., 13] > 0.2
    return rows, valid


@pytest.mark.parametrize("mode", ["2d", "3d"])
@pytest.mark.parametrize("class_agnostic", [False, True])
def test_nms_matches_jax(mode, class_agnostic):
    rows, valid = decode_rows()
    kw = dict(mode=mode, iou_thresh=0.3, class_agnostic=class_agnostic)
    ours = apply_nms(torch.from_numpy(rows), torch.from_numpy(valid), **kw).numpy()
    theirs = np.asarray(jax_apply_nms(jnp.asarray(rows), jnp.asarray(valid), **kw))
    np.testing.assert_array_equal(ours, theirs)
    assert 0 < ours.sum() < valid.sum()
    assert not (ours & ~valid).any()


@pytest.fixture(scope="module")
def diag_inputs():
    cfg = get_cfg_defaults()
    cfg.merge_from_file(RUN_YAML)
    batch = make_train_batch(2, 64, 128, seed=3)
    rng = np.random.RandomState(4)
    reg = [(rng.randn(2, 16, 32, ch) * 0.5).astype(np.float32)
           for group in cfg.MODEL.HEAD.REGRESSION_CHANNELS for ch in group]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    treg = [torch.from_numpy(r).permute(0, 3, 1, 2) for r in reg]
    return (JaxDiagnosticEvaluator(cfg), jbatch, tuple(jnp.asarray(r) for r in reg),
            DiagnosticEvaluator(cfg), tbatch, treg)


def assert_dicts_close(ours, theirs, tol):
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_allclose(float(ours[key]), float(theirs[key]), err_msg=key, **tol)


def test_depth_errors_match_jax(diag_inputs):
    jdiag, jbatch, jreg, diag, tbatch, treg = diag_inputs
    ours = diag.evaluate_depths(tbatch, treg)
    assert len(ours) == 12
    assert_dicts_close(ours, jax.jit(jdiag.evaluate_depths)(jbatch, jreg), DEPTH_TOL)


@pytest.mark.parametrize("output_depth", ["soft", "direct"])
def test_disentangled_iou_matches_jax(diag_inputs, output_depth):
    jdiag, jbatch, jreg, diag, tbatch, treg = diag_inputs
    ours = diag.evaluate_disentangled_iou(tbatch, treg, output_depth)
    assert len(ours) == 5
    theirs = jax.jit(jdiag.evaluate_disentangled_iou, static_argnums=2)(jbatch, jreg,
                                                                        output_depth)
    assert_dicts_close(ours, theirs, IOU_TOL)
    assert float(ours["dims_IoU"]) > 0
