"""Evaluation entry points: dataset sweep -> decode -> KITTI txts -> AP
evaluation (counterpart of ``monoflex_tpu/engine/inference.py``).

Batches of ``TEST.IMS_PER_BATCH`` images run through one eval step (forward
+ decode, ``train/train_step.py::make_eval_step``); the loader's threads
build numpy batches and the sweep moves each one to the device here, in the
calling thread.  ``inference_all_depths`` re-runs the sweep under each of
the 8 depth-ensemble modes.  One process: the JAX package's multi-host
sharding of the sweep is not ported yet.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.loader import make_test_loader
from ..decode.kitti_writer import write_kitti_results
from ..eval import evaluate_python

# the reference's 8-way sweep, oracle included (reference: engine/inference.py:154)
DEPTH_METHODS = ["direct", "keypoints_center", "keypoints_02", "keypoints_13",
                 "hard", "soft", "mean", "oracle"]


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def compute_on_dataset(eval_step: Callable, loader, output_dir: str,
                       output_depth: Optional[str] = None,
                       logger: Optional[logging.Logger] = None,
                       device="cuda") -> Dict[str, float]:
    """Run the eval step over the loader; write one KITTI txt per image.
    The time per image covers the move to the device, the step and the
    rows' way back (host IO of the loader overlaps it in its threads)."""
    total = 0.0
    n_images = 0
    os.makedirs(output_dir, exist_ok=True)
    for batch in loader:
        t0 = time.perf_counter()
        result, valid, _ = eval_step(to_device(batch, device), output_depth=output_depth)
        result, valid = result.cpu().numpy(), valid.cpu().numpy()
        total += time.perf_counter() - t0
        n_images += result.shape[0]
        write_kitti_results(output_dir, batch["image_id"], result, valid)
    stats = {"images": n_images, "s_per_img": total / max(n_images, 1)}
    if logger:
        logger.info(f"inference: {n_images} images, "
                    f"{stats['s_per_img'] * 1000:.2f} ms/img (incl. host IO)")
    return stats


def run_diagnostics(cfg, model: torch.nn.Module, loader, logger: logging.Logger,
                    device="cuda") -> Dict[str, float]:
    """Depth-error suite + disentangled IoU over the dataset, averaged over
    the labelled objects (reference: engine/inference.py eval_utils)."""
    from ..decode.diagnostics import DiagnosticEvaluator

    diag = DiagnosticEvaluator(cfg)
    iou_depth = "direct" if cfg.MODEL.HEAD.OUTPUT_DEPTH == "direct" else "soft"
    sums: Dict[str, float] = {}
    total = 0.0
    model.eval()
    for np_batch in loader:
        batch = to_device(np_batch, device)
        with torch.inference_mode():
            outputs = model(batch["image"], batch.get("edge_indices"), batch.get("edge_len"))
            res = {}
            if cfg.TEST.EVAL_DEPTH:
                res.update({f"depth_err/{k}": v for k, v in
                            diag.evaluate_depths(batch, outputs["reg"]).items()})
            if cfg.TEST.EVAL_DIS_IOUS:
                res.update({f"dis_iou/{k}": v for k, v in diag.evaluate_disentangled_iou(
                    batch, outputs["reg"], iou_depth).items()})
        # weight by the batch's object count for the dataset-level mean
        n = float(batch["reg_mask"].sum())
        total += n
        for k, v in res.items():
            sums[k] = sums.get(k, 0.0) + float(v) * n
    results = {k: v / max(total, 1.0) for k, v in sums.items()}
    for k, v in sorted(results.items()):
        logger.info(f"{k}: {v:.4f}")
    return results


def inference(cfg, eval_step: Callable, dataset, output_dir: str, metrics=("R40",),
              logger: Optional[logging.Logger] = None, output_depth: Optional[str] = None,
              model: Optional[torch.nn.Module] = None, visualize: bool = False,
              device="cuda") -> Dict[str, float]:
    """Decode the dataset into ``output_dir/data``, run the diagnostics when
    TEST.EVAL_DEPTH / EVAL_DIS_IOUS ask (and ``model`` is given), and return
    the official AP of each metric with the sweep's stats.  A root without
    ``label_2`` (a KITTI submission) gets the txts and no AP."""
    if visualize:
        raise NotImplementedError("visualize: utils/visualizer.py is not ported")
    logger = logger or logging.getLogger("monoflex.inference")
    batch_size = max(1, cfg.TEST.IMS_PER_BATCH)
    pred_dir = os.path.join(output_dir, "data")
    stats = compute_on_dataset(eval_step, make_test_loader(cfg, dataset, batch_size=batch_size),
                               pred_dir, output_depth=output_depth, logger=logger,
                               device=device)
    if model is not None and (cfg.TEST.EVAL_DEPTH or cfg.TEST.EVAL_DIS_IOUS):
        loader = make_test_loader(cfg, dataset, batch_size=batch_size)
        stats.update(run_diagnostics(cfg, model, loader, logger, device=device))

    label_dir = os.path.join(dataset.root, "label_2")
    split_file = os.path.join(dataset.root, "ImageSets", f"{dataset.split}.txt")
    if not os.path.isdir(label_dir):
        # keyed on label availability, not the split name: a labelled
        # holdout named "test" still gets AP
        logger.info(f"no labels at {label_dir}; skipping AP (predictions in {pred_dir})")
        return stats
    results = {}
    for metric in metrics:
        text, ret = evaluate_python(label_dir, pred_dir, split_file,
                                    cfg.DATASETS.DETECT_CLASSES, metric=metric,
                                    difficulty_scale=float(cfg.TEST.AP_DIFFICULTY_SCALE))
        logger.info(f"metric = {metric}\n{text}")
        results.update(ret)
    results.update(stats)
    return results


def inference_all_depths(cfg, eval_step: Callable, dataset, output_dir: str,
                         logger: Optional[logging.Logger] = None,
                         device="cuda") -> Dict[str, Dict]:
    """Sweep every depth-ensemble mode (reference: engine/inference.py:130-197);
    each writes under ``output_dir/depth_<mode>``."""
    logger = logger or logging.getLogger("monoflex.inference")
    all_results = {}
    for method in list(cfg.TEST.EVAL_DEPTH_METHODS) or DEPTH_METHODS:
        logger.info(f"depth method: {method}")
        all_results[method] = inference(cfg, eval_step, dataset,
                                        os.path.join(output_dir, f"depth_{method}"),
                                        logger=logger, output_depth=method, device=device)
    return all_results
