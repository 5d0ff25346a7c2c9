"""The port's kernel-diagnostics tools, counterparts of the JAX package's
``tools/kernel_bench.py``, ``kernel_diag.py``, ``fwd_ablate.py`` and
``transpose_ablate.py``, with the same flags and output lines::

    python -m monoflex_tpu_torch.tools.kernel_bench --variants f32r2,bf16r1 --bwd
    python -m monoflex_tpu_torch.tools.kernel_diag --shapes 0,4
    python -m monoflex_tpu_torch.tools.fwd_ablate --parity
    python -m monoflex_tpu_torch.tools.transpose_ablate

Their entry points run on the card and exit non-zero without one; their
functions take ``device=`` for the CPU tests.  With the environment variable
``MONOFLEX_TORCH_LAUNCH_LOG`` set to a path, a tool writes the kernel launch
counts of its run there as JSON when it ends (``chip_smoke.py`` reads them).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

LAUNCH_LOG_ENV = "MONOFLEX_TORCH_LAUNCH_LOG"


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by the name ``chip_smoke.py``'s
    kernels line gives the kernel."""
    from ..ops import dcn_ablate, dcn_cuda, relayout

    counts = {}
    for name, wrapper in (("dcn_fwd", dcn_cuda.dcn_forward), ("dcn_bwd_dx", dcn_cuda.dcn_bwd_dx),
                          ("dcn_bwd_dwmo", dcn_cuda.dcn_bwd_dwmo)):
        counts[name] = wrapper.launches
        counts[f"{name}[bf16 math]"] = wrapper.bf16_math_launches
    counts["dcn_fwd_bn_relu"] = dcn_cuda.dcn_forward_bn_relu.launches
    counts.update({f"dcn_ablate[{v}]": n for v, n in dcn_ablate.dcn_ablate.launches.items()})
    counts["relayout"] = relayout.relayout.launches
    return counts


def require_cuda(tool: str) -> None:
    """Exit non-zero unless a CUDA device is present: the tools measure the
    card's kernels and have no CPU path."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device; the port's kernels run only on the GPU")
    # the default config's precision: full-f32 matmuls and convolutions on
    # both sides of every comparison
    from ..config import get_cfg_defaults
    from ..utils.precision import apply_precision

    apply_precision(get_cfg_defaults())


def write_launch_log() -> None:
    """Write ``launch_counts()`` to the path in MONOFLEX_TORCH_LAUNCH_LOG, if set."""
    path = os.environ.get(LAUNCH_LOG_ENV)
    if path:
        with open(path, "w") as f:
            json.dump(launch_counts(), f)
