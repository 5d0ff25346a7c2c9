"""The matmul and convolution precision of the port, resolved from the config.

torch keeps these as process globals: ``torch.backends.cudnn.allow_tf32``
(True by default, so cuDNN convolutions run in TF32),
``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn.benchmark``.
The port sets them from the config wherever a model is built or an entry
point receives one, so that a run takes the precision class its config names
and the tests hold, not torch's default.

- ``TPU.COMPUTE_DTYPE`` "float32" or "bfloat16": TF32 off either way, so
  every op that runs in f32 (all of them under "float32"; under "bfloat16"
  the parameters, the BN and GN arithmetic, the DCN, the heads' output convs,
  the losses and the decode) runs in full f32.  bf16 is no torch flag and no
  ``torch.autocast``: it is the dtype of the trunk, the neck and the head
  towers, set on those modules where the JAX package sets flax's ``dtype``
  (``compute_dtype`` below, ``models/layers.py``).  Autocast would also move
  the heads' output convs, the DCN and the decode into bf16.
- ``CUDNN_BENCHMARK``: the reference's cuDNN autotune toggle, read here.
"""

from __future__ import annotations

from typing import Dict

import torch

FLAGS = ("cuda.matmul.allow_tf32", "cudnn.allow_tf32", "cudnn.benchmark")


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg) -> torch.dtype:
    """The torch dtype of ``TPU.COMPUTE_DTYPE``; raises on a name that is
    neither "float32" nor "bfloat16"."""
    name = cfg.TPU.COMPUTE_DTYPE
    if name not in COMPUTE_DTYPES:
        raise NotImplementedError(f"TPU.COMPUTE_DTYPE {name!r}: one of {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def resolve_precision(cfg) -> Dict[str, bool]:
    """The three torch flags that ``cfg`` asks for, by their names in FLAGS;
    the same for both compute dtypes."""
    compute_dtype(cfg)
    return {"cuda.matmul.allow_tf32": False, "cudnn.allow_tf32": False,
            "cudnn.benchmark": bool(cfg.CUDNN_BENCHMARK)}


def apply_precision(precision) -> Dict[str, bool]:
    """Set the torch flags from a config or from ``resolve_precision``'s
    dict; returns the dict."""
    # a config node is a dict too: tell them apart by the config's section
    flags = resolve_precision(precision) if "TPU" in precision else precision
    torch.backends.cuda.matmul.allow_tf32 = flags["cuda.matmul.allow_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn.allow_tf32"]
    torch.backends.cudnn.benchmark = flags["cudnn.benchmark"]
    return flags


def current_precision() -> Dict[str, bool]:
    """The three flags as torch holds them now."""
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn.benchmark": torch.backends.cudnn.benchmark}
