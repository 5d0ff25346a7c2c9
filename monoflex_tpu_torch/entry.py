"""Entry points of the port, the counterparts of the JAX package's
``__graft_entry__.py``.

``entry()`` returns ``(fn, example_args)``: ``fn(model, batch) -> (result,
valid)`` is the benchmark's forward and decode (``bench.py::infer``) and
``example_args`` is ``(model, batch)``: ``runs/monoflex.yaml``'s model with
weights from seed 0 and a uint8 batch of 8 at the test input size
(384x1280), both on the card.  ``dryrun_multichip(n)`` is one training step
over n processes, re-exported from ``parallel/dryrun.py``, whose command
line ``python -m monoflex_tpu_torch.parallel.dryrun N`` runs it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .bench import bench_config, infer
from .data.synthetic import make_inference_batch
from .decode.postprocessor import PostProcessor
from .models.detector import build_model
from .parallel.dryrun import dryrun_multichip

__all__ = ["entry", "dryrun_multichip"]


def entry(*, device="cuda", cfg=None, batch_size: int = 8) -> Tuple[Callable, tuple]:
    """(fn, (model, batch)) of the forward and decode on ``device`` (the
    card unless the caller asks for the CPU), for ``cfg`` (default
    ``runs/monoflex.yaml``) at ``batch_size`` and the config's test input."""
    cfg = bench_config({}) if cfg is None else cfg
    model = build_model(cfg, device=device, seed=0)
    post = PostProcessor(cfg)
    batch = {k: torch.from_numpy(v).to(device) for k, v in make_inference_batch(
        batch_size, cfg.INPUT.HEIGHT_TEST, cfg.INPUT.WIDTH_TEST).items()}

    def forward(model, batch):
        return infer(model, post, batch)

    return forward, (model, batch)
