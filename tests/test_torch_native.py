"""The port's C++ evaluator fast path (``monoflex_tpu_torch.native``, a copy
of the JAX package's ``monoflex_tpu/native``) against the port's numpy
evaluator, and against the JAX evaluator.

Tolerances.  Overlaps: 1e-9 abs for the rotated BEV and 3D overlaps (the
C++ and numpy polygon clippers sum the same terms in double, in another
order), 1e-12 for the axis-aligned 2D overlap (the same arithmetic).  APs:
equal, since the per-threshold counts are integers and the overlaps lie far
from every IoU threshold at the 1e-9 level.
"""

import logging
import os

import numpy as np
import pytest

import monoflex_tpu_torch.native as native
from monoflex_tpu.eval import evaluate_python as jax_evaluate_python
from monoflex_tpu_torch.eval import evaluate_python
from monoflex_tpu_torch.eval import rotate_iou as R
from test_torch_eval import CLASSES, tree  # noqa: F401 (fixture)

pytestmark = pytest.mark.skipif(native.load_native() is None, reason="needs g++")


def rotated_boxes(seed, n):
    rng = np.random.RandomState(seed)
    boxes = np.stack([rng.uniform(-10, 10, n), rng.uniform(0, 60, n), rng.uniform(1, 5, n),
                      rng.uniform(1, 3, n), rng.uniform(-3, 3, n)], axis=1)
    return boxes, boxes + rng.randn(n, 5) * 0.5


def camera_boxes(seed, n):
    """(N, 7) [x y z l h w ry] and a perturbed copy."""
    rng = np.random.RandomState(seed)
    boxes = np.stack([rng.uniform(-10, 10, n), rng.uniform(1, 2, n), rng.uniform(5, 50, n),
                      rng.uniform(3, 5, n), rng.uniform(1.4, 1.8, n), rng.uniform(1.5, 2, n),
                      rng.uniform(-3, 3, n)], axis=1)
    return boxes, boxes + rng.randn(n, 7) * 0.4


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_rotated_overlap_matches_numpy(criterion):
    boxes, qboxes = rotated_boxes(0, 40)
    got = native.rotate_iou_eval_native(boxes, qboxes, criterion)
    with native.numpy_only():
        ref = R.rotate_iou_eval(boxes, qboxes, criterion)
    assert (ref > 0).sum() > 40
    np.testing.assert_allclose(got, ref, atol=1e-9)
    np.testing.assert_allclose(R.rotate_iou_eval(boxes, qboxes, criterion), ref, atol=1e-9)


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_3d_overlap_matches_numpy(criterion):
    boxes, qboxes = camera_boxes(1, 30)
    got = R.d3_box_overlap(boxes, qboxes, criterion)
    with native.numpy_only():
        ref = R.d3_box_overlap(boxes, qboxes, criterion)
    assert (ref > 0).sum() >= 30
    np.testing.assert_allclose(got, ref, atol=1e-9)
    np.testing.assert_allclose(native.d3_box_overlap_native(boxes, qboxes, criterion), ref,
                               atol=1e-9)


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_image_overlap_matches_numpy(criterion):
    rng = np.random.RandomState(2)
    x1, y1 = rng.uniform(0, 100, (30, 1)), rng.uniform(0, 100, (30, 1))
    boxes = np.concatenate([x1, y1, x1 + rng.uniform(5, 50, (30, 1)),
                            y1 + rng.uniform(5, 50, (30, 1))], axis=1)
    q = boxes + rng.randn(30, 4) * 3
    q[:, 2] = np.maximum(q[:, 2], q[:, 0] + 1)
    q[:, 3] = np.maximum(q[:, 3], q[:, 1] + 1)
    np.testing.assert_allclose(native.image_box_overlap_native(boxes, q, criterion),
                               R.image_box_overlap(boxes, q, criterion), atol=1e-12)


def evaluate(evaluator, root, pred_dir, metric):
    return evaluator(os.path.join(root, "label_2"), pred_dir,
                     os.path.join(root, "ImageSets", "trainval.txt"), CLASSES, metric=metric)


@pytest.mark.parametrize("metric", ["R40", "R11"])
def test_native_aps_equal_numpy_and_jax(tree, metric):  # noqa: F811
    """Detections that are the ground truth perturbed (and a few false
    positives): the C++ path's table and APs equal the numpy path's and the
    JAX evaluator's (its C++ path where it loads)."""
    root, noisy, _ = tree
    assert native.evaluator_path() == "native"
    text, ap = evaluate(evaluate_python, root, noisy, metric)
    with native.numpy_only():
        assert native.evaluator_path() == "numpy"
        np_text, np_ap = evaluate(evaluate_python, root, noisy, metric)
    jtext, jap = evaluate(jax_evaluate_python, root, noisy, metric)
    assert text == np_text == jtext
    assert ap.keys() == np_ap.keys() == jap.keys() and len(ap) == 54
    for key in ap:
        assert ap[key] == np_ap[key] == jap[key], key
    assert 0 < ap["Car_3d_0.50/moderate"] < 100


def test_native_perfect_predictions_reach_the_top(tree):  # noqa: F811
    """Labels as predictions: 100 AP for Car (more than 41 valid objects a
    difficulty), on the C++ path."""
    root, _, exact = tree
    ap = evaluate(evaluate_python, root, exact, "R40")[1]
    for key in ("image", "3d_0.70", "bev_0.70", "aos"):
        for diff in ("easy", "moderate", "hard"):
            assert ap[f"Car_{key}/{diff}"] == pytest.approx(100.0), (key, diff)


def test_without_a_compiler_the_numpy_path(monkeypatch, tmp_path, caplog):
    """No g++ and no built library: load_native returns None, the evaluator
    takes its numpy path, and says so once."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with caplog.at_level(logging.INFO, logger="monoflex"):
        assert native.load_native() is None
        assert native.evaluator_path() == "numpy"
    said = [r.getMessage() for r in caplog.records if "KITTI evaluator" in r.getMessage()]
    assert said == ["KITTI evaluator: no g++ on PATH, so no C++ fast path",
                    "KITTI evaluator: numpy path"]
    boxes, qboxes = rotated_boxes(3, 5)
    with pytest.raises(RuntimeError, match="not loaded"):
        native.rotate_iou_eval_native(boxes, qboxes)


def test_builds_into_the_gitignored_build_dir(monkeypatch, tmp_path, caplog):
    """A fresh build lands under _build/native (here a temporary one), named
    by the hash of the source and flags, and the load logs the native path
    once."""
    default = native.BUILD_DIR
    assert default.parent.name == "_build" and default.parent.parent.name == "monoflex_tpu_torch"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with caplog.at_level(logging.INFO, logger="monoflex"):
        lib = native.load_native()
        native.load_native()
    assert lib is not None
    assert native.library_path().parent == tmp_path / "native"
    assert native.library_path().exists()
    said = [r.getMessage() for r in caplog.records if "KITTI evaluator" in r.getMessage()]
    assert len(said) == 1 and said[0].startswith("KITTI evaluator: native path")
