"""Device A/B of the two forms of ``BilinearUp`` (the phase decomposition
and the transposed conv, "dilated") at the model's upsampling shapes, the
counterpart of the JAX package's ``tools/bilinear_ablate.py``::

    python -m monoflex_tpu_torch.tools.bilinear_ablate
    ABL_GRAD=1 ABL_ITERS=20 ABL_OUT=output/bilinear.jsonl python -m ...

For each entry of ``SHAPES`` ((B, H, W, C), factor, calls per forward at
384x1280 and batch 8) and each form, the device time of one call from a
torch.profiler trace (``tools/trace_time.py``), f32, channels-last as the
model runs it: the forward alone, or with ``ABL_GRAD`` set the gradient of
sum(y^2) with respect to the weight and x (the training step's share).
``ABL_ITERS`` (10) calls are traced.  One JSON line per record; with
``ABL_OUT`` each is also appended to that file.  Exits non-zero without a
card.  (No kernel of the port runs here: the launch counts it writes under
``MONOFLEX_TORCH_LAUNCH_LOG`` are 0.)
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models.backbone.dla import BilinearUp
from . import require_cuda, write_launch_log
from .trace_time import device_time

# (B, H, W, C), factor, count-per-forward at 384x1280 batch 8
SHAPES = [
    ((8, 12, 40, 256), 2, 1),
    ((8, 24, 80, 128), 2, 2),
    ((8, 48, 160, 64), 2, 4),
    ((8, 24, 80, 64), 4, 1),
]


def make_run(x: torch.Tensor, factor: int, impl: str, grad: bool):
    """A call of the ``impl`` form on x (NCHW, channels-last), with the
    bilinear weights of its init."""
    up = BilinearUp(x.shape[1], factor, impl=impl).to(x.device)
    if not grad:
        def run():
            with torch.no_grad():
                return up(x)
        return run
    x = x.detach().requires_grad_(True)

    def run_grad():
        return torch.autograd.grad((up(x) ** 2).sum(), (up.weight, x))
    return run_grad


def main() -> None:
    iters = int(os.environ.get("ABL_ITERS", "10"))
    grad = bool(os.environ.get("ABL_GRAD"))
    out_path = os.environ.get("ABL_OUT")
    require_cuda("bilinear_ablate")
    rng = np.random.RandomState(0)
    for shape, f, n in SHAPES:
        # NHWC memory, as the JAX tool draws it: a channels-last NCHW view
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda().permute(0, 3, 1, 2)
        for impl in ("phase", "dilated"):
            ms, _ = device_time(make_run(x, f, impl, grad), iters=iters)
            rec = {"shape": list(shape), "factor": f, "per_fwd": n, "impl": impl, "grad": grad,
                   "ms_device": round(ms, 4), "device": torch.cuda.get_device_name(0)}
            line = json.dumps(rec)
            print(line, flush=True)
            if out_path:
                with open(out_path, "a") as fh:
                    fh.write(line + "\n")
    write_launch_log()


if __name__ == "__main__":
    main()
