"""The port's KITTI reader and test loader (numpy copies of the JAX package's)
against the JAX ones on a 1/4-scale synthetic tree: the train split with the
seeded flip augmentation, the test split, the cached-flip dataset, and the
padded last batch of ``make_test_loader``.  Every array must be equal."""

import os
import sys

import numpy as np
import pytest

from monoflex_tpu.config import get_cfg_defaults as jax_cfg_defaults
from monoflex_tpu.data import dataset as JD
from monoflex_tpu.data.loader import make_test_loader as jax_make_test_loader
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data import dataset as PD
from monoflex_tpu_torch.data.loader import make_test_loader

sys.path.insert(0, os.path.dirname(__file__))
from synthetic_kitti import make_synthetic_kitti  # noqa: E402

RUN_YAML = os.path.join(os.path.dirname(__file__), "..", "runs", "monoflex.yaml")
OPTS = ["INPUT.HEIGHT_TRAIN", 96, "INPUT.WIDTH_TRAIN", 320, "INPUT.HEIGHT_TEST", 96,
        "INPUT.WIDTH_TEST", 320, "DATALOADER.NUM_WORKERS", 2]


def both_cfgs(*opts):
    out = []
    for make in (get_cfg_defaults, jax_cfg_defaults):
        cfg = make()
        cfg.merge_from_file(RUN_YAML)
        cfg.merge_from_list(OPTS + list(opts))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti") / "training"), scale=4,
                                n_random_frames=5, render=True)


def assert_samples_equal(ours, theirs):
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
        assert ours[key].dtype == theirs[key].dtype, key


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
def test_dataset_matches_jax(root, is_train):
    cfg, jcfg = both_cfgs()
    ours = PD.KITTIDataset(cfg, root, is_train=is_train, seed=3)
    theirs = JD.KITTIDataset(jcfg, root, is_train=is_train, seed=3)
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        assert_samples_equal(ours[i], theirs[i])
    if is_train:
        assert ours.augmentations, "the train split draws the seeded flip"


def test_cached_flip_dataset_matches_jax(root):
    cfg, jcfg = both_cfgs()
    ours = PD.CachedFlipDataset(cfg, root, is_train=True, seed=5)
    theirs = JD.CachedFlipDataset(jcfg, root, is_train=True, seed=5)
    for i in list(range(len(ours))) * 2:
        assert_samples_equal(ours[i], theirs[i])


def test_test_loader_matches_jax_and_pads(root):
    cfg, jcfg = both_cfgs("TEST.IMS_PER_BATCH", 3, "DATASETS.TEST_SPLIT", "trainval")
    ours = list(make_test_loader(cfg, PD.KITTIDataset(cfg, root, is_train=False)))
    theirs = list(jax_make_test_loader(jcfg, JD.KITTIDataset(jcfg, root, is_train=False)))
    assert len(ours) == len(theirs) == 3          # 8 frames -> 3 + 3 + (2 + 1 pad)
    for a, b in zip(ours, theirs):
        assert_samples_equal(a, b)
    assert ours[-1]["image_id"][-1] == -1 and not ours[-1]["reg_mask"][-1].any()
