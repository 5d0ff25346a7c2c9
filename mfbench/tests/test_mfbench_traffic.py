"""Each traffic mix's generator gives the same inputs from the same seed,
and other inputs from another."""

import filecmp
import os

import numpy as np
import pytest

from mfbench import synth
from mfbench.spec import load_json, data_file

OBJECTS = {"min": 1, "max": 15, "mean": 4.7}


@pytest.mark.parametrize("make", [synth.train_batches, synth.inference_batches])
def test_pools_repeat_from_the_seed(make):
    kw = dict(batch=2, height=64, width=128, objects=OBJECTS)
    a, b = make(2 ** 31 + 17, 3, **kw), make(2 ** 31 + 17, 3, **kw)
    c = make(2 ** 31 + 18, 3, **kw)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(x[k], y[k]), k
    assert not np.array_equal(a[0]["image"], c[0]["image"])
    # a pool's first batches do not depend on its size
    assert np.array_equal(make(5, 1, **kw)[0]["image"], make(5, 3, **kw)[0]["image"])


def test_kitti_tree_repeats_from_the_seed(tmp_path):
    traffic = load_json(data_file("traffic", "train_loop"))
    trees = []
    for name, seed in (("a", 2 ** 31 + 5), ("b", 2 ** 31 + 5), ("c", 6)):
        root = str(tmp_path / name)
        counts = synth.write_kitti_tree(root, seed, 4, 310, 94, traffic["objects"],
                                        traffic["class_shares"], workers=2)
        trees.append((root, counts))
    (a, ca), (b, cb), (c, cc) = trees
    assert ca == cb and all(1 <= n <= 15 for n in ca)
    for sub in ("image_2", "label_2", "calib", "ImageSets"):
        names = sorted(os.listdir(os.path.join(a, sub)))
        match, mismatch, errors = filecmp.cmpfiles(os.path.join(a, sub), os.path.join(b, sub),
                                                   names, shallow=False)
        assert not mismatch and not errors, (sub, mismatch, errors)
    assert not filecmp.cmp(os.path.join(a, "image_2", "000000.png"),
                           os.path.join(c, "image_2", "000000.png"), shallow=False)


def test_object_counts_follow_the_mix():
    rng = synth.rng_for(3, 0)
    counts = synth.object_counts(rng, 20000, OBJECTS)
    assert counts.min() >= 1 and counts.max() <= 15
    assert counts.mean() == pytest.approx(4.7, abs=0.05)


def test_every_mix_names_a_kind_and_a_source_found_by_name():
    from mfbench.harness import load_module

    folder = os.path.dirname(data_file("traffic", "x"))
    for name in sorted(os.listdir(folder)):
        mix = load_json(os.path.join(folder, name))
        kind = load_module("kinds", mix["kind"])
        assert callable(kind.drive) and callable(kind.judge) and callable(kind.failed)
        assert callable(load_module("sources", mix["source"]).make)
