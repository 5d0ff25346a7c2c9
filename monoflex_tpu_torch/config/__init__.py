"""The config tree: the port's own copy of the JAX package's yacs-style nodes,
YAML merge, defaults and class-id tables, so ``runs/*.yaml`` configure both
packages alike (``tests/test_torch_config.py`` holds the two copies equal)."""

from .defaults import _C as cfg
from .node import CfgNode
from .paths_catalog import DatasetCatalog

# KITTI class name -> training id.  Negative ids are ignore / neighbor classes
# (reference: config/__init__.py:3-14).
TYPE_ID_CONVERSION = {
    "Car": 0,
    "Pedestrian": 1,
    "Cyclist": 2,
    "Van": -4,
    "Truck": -4,
    "Person_sitting": -2,
    "Tram": -99,
    "Misc": -99,
    "DontCare": -1,
}

ID_TYPE_CONVERSION = {0: "Car", 1: "Pedestrian", 2: "Cyclist"}


def get_cfg_defaults() -> CfgNode:
    """A fresh clone of the default config (prefer over mutating the global)."""
    return cfg.clone()


__all__ = [
    "cfg",
    "CfgNode",
    "DatasetCatalog",
    "TYPE_ID_CONVERSION",
    "ID_TYPE_CONVERSION",
    "get_cfg_defaults",
]
