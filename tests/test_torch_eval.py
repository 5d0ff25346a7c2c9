"""The port's KITTI evaluator (a numpy copy of the JAX package's) against the
JAX one on the same label and prediction directories, R40 and R11: equal
tables and equal AP dicts.  The JAX evaluator may swap in its C++ overlap
and statistics code; the port has only the numpy path, so the comparison
turns the C++ path off on the JAX side.  And labels written back as
predictions score 100 AP where a class has at least 41 valid objects (the
evaluator fills one precision sample per score threshold, so a class with n
objects tops out at (n - 1) / 40 of the R40 points)."""

import os
import sys

import numpy as np
import pytest

import monoflex_tpu.native
from monoflex_tpu.eval import evaluate_python as jax_evaluate_python
from monoflex_tpu_torch.eval import evaluate_python

sys.path.insert(0, os.path.dirname(__file__))
from synthetic_kitti import make_synthetic_kitti  # noqa: E402

CLASSES = ("Car", "Pedestrian", "Cyclist")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A full-size labelled tree (noise images: only the labels are read),
    noisy predictions with false positives, and the labels as predictions."""
    base = tmp_path_factory.mktemp("eval")
    root = make_synthetic_kitti(str(base / "training"), n_random_frames=40)
    rng = np.random.RandomState(0)
    ids = [s.strip() for s in open(os.path.join(root, "ImageSets", "trainval.txt"))]
    noisy, exact = base / "noisy", base / "exact"
    noisy.mkdir()
    exact.mkdir()
    for i in ids:
        lines = [ln.split() for ln in open(os.path.join(root, "label_2", f"{i}.txt"))]
        objs = [ln for ln in lines if ln[0] in CLASSES]
        with open(exact / f"{i}.txt", "w") as f:        # distinct scores
            f.writelines(" ".join(ln + [f"{rng.uniform(0.5, 1):.6f}"]) + "\n" for ln in objs)
        with open(noisy / f"{i}.txt", "w") as f:
            for ln in objs:
                vals = np.array(ln[3:], np.float64)
                vals[1:5] += rng.randn(4) * 3            # box2d, px
                vals[8:11] += rng.randn(3) * 0.3         # location, m
                vals[11] += rng.randn() * 0.1            # rotation_y
                f.write(" ".join(ln[:3] + [f"{v:.2f}" for v in vals]
                                 + [f"{rng.uniform(0.3, 1):.4f}"]) + "\n")
            for _ in range(rng.randint(0, 4)):              # false positives
                x, y, z = rng.uniform(-10, 10), 1.6, rng.uniform(5, 50)
                u = rng.uniform(0, 1100)
                f.write(f"{CLASSES[rng.randint(3)]} 0 0 0.1 {u:.2f} 150.00 {u + 60:.2f} "
                        f"220.00 1.50 1.60 3.90 {x:.2f} {y:.2f} {z:.2f} 0.30 "
                        f"{rng.uniform(0, 0.6):.4f}\n")
    return root, str(noisy), str(exact)


def run_both(root, pred_dir, metric):
    args = (os.path.join(root, "label_2"), pred_dir,
            os.path.join(root, "ImageSets", "trainval.txt"), CLASSES)
    return evaluate_python(*args, metric=metric), jax_evaluate_python(*args, metric=metric)


@pytest.mark.parametrize("metric", ["R40", "R11"])
def test_evaluator_matches_jax(tree, metric, monkeypatch):
    monkeypatch.setattr(monoflex_tpu.native, "load_native", lambda: None)
    root, noisy, _ = tree
    (text, ap), (jtext, jap) = run_both(root, noisy, metric)
    assert text == jtext
    assert ap.keys() == jap.keys() and len(ap) == 54
    for key in ap:
        assert ap[key] == jap[key], key
    assert 0 < ap["Car_3d_0.50/moderate"] < 100


def test_labels_as_predictions_score_100(tree):
    root, _, exact = tree
    ap = evaluate_python(os.path.join(root, "label_2"), exact,
                         os.path.join(root, "ImageSets", "trainval.txt"), CLASSES)[1]
    for key in ("image", "3d_0.70", "bev_0.70", "aos"):
        for diff in ("easy", "moderate", "hard"):
            assert ap[f"Car_{key}/{diff}"] == pytest.approx(100.0), (key, diff)
    for cls in CLASSES[1:]:    # fewer objects: perfect up to their sample count
        assert 0 < ap[f"{cls}_3d_0.50/moderate"] == ap[f"{cls}_image/moderate"]
