"""Test-split dispatch (counterpart of ``monoflex_tpu/engine/test_net.py``;
reference: engine/test_net.py:9-35)."""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional

from ..utils.precision import apply_precision
from .inference import inference, inference_all_depths


def run_test(cfg, eval_step: Callable, dataset, eval_all_depths: bool = False,
             logger: Optional[logging.Logger] = None, device="cuda"):
    """Decode ``dataset`` into ``OUTPUT_DIR/inference_test`` (every depth
    mode with ``eval_all_depths``), with AP where the root has labels,
    under the precision flags of ``cfg``."""
    apply_precision(cfg)
    output_dir = os.path.join(cfg.OUTPUT_DIR, "inference_test")
    if eval_all_depths:
        return inference_all_depths(cfg, eval_step, dataset, output_dir, logger=logger,
                                    device=device)
    return inference(cfg, eval_step, dataset, output_dir, metrics=cfg.TEST.METRIC,
                     logger=logger, device=device)
