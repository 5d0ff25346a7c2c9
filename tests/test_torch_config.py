"""The port's own config package against the JAX package's: the same tree, as a
plain dict, for the defaults and for every ``runs/*.yaml`` merged in, the
same class-id tables and dataset catalog, and the same merge behaviour.  It
also catches the two copies drifting apart."""

import glob
import os

import pytest

import monoflex_tpu.config as J
import monoflex_tpu_torch.config as P
from monoflex_tpu.config.node import _to_plain as jax_plain
from monoflex_tpu_torch.config.node import _to_plain

RUNS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "runs", "*.yaml")))


def test_there_are_run_configs():
    assert len(RUNS) >= 4


def test_the_port_keeps_its_own_copy():
    assert P.CfgNode is not J.CfgNode
    assert P.cfg is not J.cfg
    assert P.CfgNode.__module__ == "monoflex_tpu_torch.config.node"


@pytest.mark.parametrize("yaml_path", [None] + RUNS,
                         ids=["defaults"] + [os.path.basename(p) for p in RUNS])
def test_config_equals_jax_config(yaml_path):
    ours, theirs = P.get_cfg_defaults(), J.get_cfg_defaults()
    if yaml_path:
        ours.merge_from_file(yaml_path)
        theirs.merge_from_file(yaml_path)
    assert type(ours) is P.CfgNode and type(theirs) is J.CfgNode
    assert _to_plain(ours) == jax_plain(theirs)
    assert ours.dump() == theirs.dump()


def test_class_tables_and_catalog_equal_jax():
    assert P.TYPE_ID_CONVERSION == J.TYPE_ID_CONVERSION
    assert P.ID_TYPE_CONVERSION == J.ID_TYPE_CONVERSION
    assert P.DatasetCatalog.DATASETS == J.DatasetCatalog.DATASETS
    assert P.DatasetCatalog.get("kitti_train") == J.DatasetCatalog.get("kitti_train")


@pytest.mark.parametrize("opts", [
    ["TEST.IMS_PER_BATCH", "3", "TPU.DCN_FORCE_IMPL", "pallas2p"],
    ["DATASETS.DETECT_CLASSES", '("Car", "Cyclist")', "TEST.DETECTIONS_THRESHOLD", "0"],
    ["TPU.DCN_MAX_OFFSET_PER_STAGE", "(8, 4, 2, 2)", "TPU.DCN_FUSE_BN_RELU", "True"],
])
def test_command_line_overrides_merge_alike(opts):
    ours, theirs = P.get_cfg_defaults(), J.get_cfg_defaults()
    ours.merge_from_list(list(opts))
    theirs.merge_from_list(list(opts))
    assert _to_plain(ours) == jax_plain(theirs)


@pytest.mark.parametrize("opts,error", [
    (["TEST.NO_SUCH_KEY", "1"], KeyError),
    (["TPU.DCN_FUSE_BN_RELU", "3"], TypeError),
    (["TEST.IMS_PER_BATCH"], ValueError),
])
def test_bad_overrides_raise_alike(opts, error):
    for cfg in (P.get_cfg_defaults(), J.get_cfg_defaults()):
        with pytest.raises(error):
            cfg.merge_from_list(list(opts))
