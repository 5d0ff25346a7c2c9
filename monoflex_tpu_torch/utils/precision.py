"""The matmul and convolution precision of the port, resolved from the config.

torch keeps these as process globals: ``torch.backends.cudnn.allow_tf32``
(True by default, so cuDNN convolutions run in TF32),
``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn.benchmark``.
The port sets them from the config wherever a model is built or an entry
point receives one, so that a run takes the precision class its config names
and the tests hold, not torch's default.

- ``TPU.COMPUTE_DTYPE`` "float32", the only value the port serves
  (``models/backbone/dla.py``): full f32 matmuls and convolutions, TF32 off.
- ``CUDNN_BENCHMARK``: the reference's cuDNN autotune toggle, read here.
"""

from __future__ import annotations

from typing import Dict

import torch

FLAGS = ("cuda.matmul.allow_tf32", "cudnn.allow_tf32", "cudnn.benchmark")


def resolve_precision(cfg) -> Dict[str, bool]:
    """The three torch flags that ``cfg`` asks for, by their names in FLAGS."""
    dtype = cfg.TPU.COMPUTE_DTYPE
    if dtype != "float32":
        raise NotImplementedError(f"TPU.COMPUTE_DTYPE {dtype!r}: only float32")
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
