"""Host-side KITTI prediction txt writer
(reference: data/datasets/evaluation/kitti_object_eval_python/evaluate.py:34-54)."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..config import ID_TYPE_CONVERSION


def result_rows_to_lines(result: np.ndarray, valid: np.ndarray) -> List[str]:
    """(K, 14) decode rows + (K,) validity -> KITTI label lines."""
    lines = []
    for row, ok in zip(result, valid):
        if not ok:
            continue
        cls_id = int(row[0])
        cls_name = ID_TYPE_CONVERSION.get(cls_id)
        if cls_name is None:
            continue
        alpha = row[1]
        box2d = row[2:6]
        hwl = row[6:9]
        xyz = row[9:12]
        ry = row[12]
        score = row[13]
        lines.append(
            f"{cls_name} 0 0 {alpha:.6f} "
            f"{box2d[0]:.6f} {box2d[1]:.6f} {box2d[2]:.6f} {box2d[3]:.6f} "
            f"{hwl[0]:.6f} {hwl[1]:.6f} {hwl[2]:.6f} "
            f"{xyz[0]:.6f} {xyz[1]:.6f} {xyz[2]:.6f} {ry:.6f} {score:.6f}")
    return lines


def write_kitti_results(output_dir: str, image_ids: np.ndarray, results: np.ndarray,
                        valids: np.ndarray) -> None:
    """Dump one txt per image: results (B, K, 14), valids (B, K)."""
    os.makedirs(output_dir, exist_ok=True)
    for img_id, result, valid in zip(image_ids, results, valids):
        if int(img_id) < 0:      # padding rows from the fixed-shape loader
            continue
        path = os.path.join(output_dir, f"{int(img_id):06d}.txt")
        with open(path, "w") as f:
            lines = result_rows_to_lines(np.asarray(result), np.asarray(valid))
            f.write("\n".join(lines))
            if lines:
                f.write("\n")
