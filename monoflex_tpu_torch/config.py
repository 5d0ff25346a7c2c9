"""The config tree, shared with the JAX package (framework-neutral: yacs-style
nodes, YAML merge, the defaults and ``runs/*.yaml``)."""

from monoflex_tpu.config import (ID_TYPE_CONVERSION, TYPE_ID_CONVERSION, CfgNode,
                                 cfg, get_cfg_defaults)

__all__ = ["cfg", "CfgNode", "TYPE_ID_CONVERSION", "ID_TYPE_CONVERSION",
           "get_cfg_defaults"]
