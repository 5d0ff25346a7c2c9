import os
from typing import Dict, Sequence, Tuple

from .ap import get_official_eval_result
from .kitti_common import get_label_anno, get_label_annos


def evaluate_python(label_path: str, result_path: str, label_split_file: str,
                    current_classes: Sequence[str] = ("Car",),
                    metric: str = "R40",
                    difficulty_scale: float = 1.0) -> Tuple[str, Dict[str, float]]:
    """Evaluate a directory of prediction txts against GT labels
    (reference: data/datasets/evaluation/__init__.py:33,
    kitti_object_eval_python/evaluate.py)."""
    with open(label_split_file) as f:
        image_ids = [line.strip() for line in f if line.strip()]
    gt_annos = get_label_annos(label_path, image_ids)
    dt_annos = get_label_annos(result_path, image_ids)
    return get_official_eval_result(gt_annos, dt_annos, list(current_classes),
                                    metric=metric,
                                    difficulty_scale=difficulty_scale)


__all__ = ["evaluate_python", "get_official_eval_result", "get_label_anno",
           "get_label_annos"]
