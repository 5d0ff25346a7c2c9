"""KITTI annotation txt parsing for the evaluator
(reference: data/datasets/evaluation/kitti_object_eval_python/kitti_common.py:294-349).

Dimensions are converted from the file's (h, w, l) to the evaluator's
standard (l, h, w) order.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np


def get_label_anno(path: str) -> Dict[str, np.ndarray]:
    annotations = {
        "name": [], "truncated": [], "occluded": [], "alpha": [], "bbox": [],
        "dimensions": [], "location": [], "rotation_y": [], "score": [],
    }
    with open(path, "r") as f:
        lines = [line.strip().split(" ") for line in f if line.strip()]
    for parts in lines:
        annotations["name"].append(parts[0])
        annotations["truncated"].append(float(parts[1]))
        annotations["occluded"].append(int(float(parts[2])))
        annotations["alpha"].append(float(parts[3]))
        annotations["bbox"].append([float(v) for v in parts[4:8]])
        # file order h, w, l -> store l, h, w
        h, w, l = (float(parts[8]), float(parts[9]), float(parts[10]))
        annotations["dimensions"].append([l, h, w])
        annotations["location"].append([float(v) for v in parts[11:14]])
        annotations["rotation_y"].append(float(parts[14]))
        annotations["score"].append(float(parts[15]) if len(parts) > 15 else -1.0)

    n = len(lines)
    return {
        "name": np.array(annotations["name"]),
        "truncated": np.array(annotations["truncated"], dtype=np.float64),
        "occluded": np.array(annotations["occluded"], dtype=np.int64),
        "alpha": np.array(annotations["alpha"], dtype=np.float64),
        "bbox": np.array(annotations["bbox"], dtype=np.float64).reshape(n, 4),
        "dimensions": np.array(annotations["dimensions"], dtype=np.float64).reshape(n, 3),
        "location": np.array(annotations["location"], dtype=np.float64).reshape(n, 3),
        "rotation_y": np.array(annotations["rotation_y"], dtype=np.float64),
        "score": np.array(annotations["score"], dtype=np.float64),
    }


def get_label_annos(label_dir: str, image_ids: Sequence[str] | None = None
                    ) -> List[Dict[str, np.ndarray]]:
    if image_ids is None:
        files = sorted(f for f in os.listdir(label_dir) if f.endswith(".txt"))
        image_ids = [os.path.splitext(f)[0] for f in files]
    annos = []
    for idx in image_ids:
        name = idx if isinstance(idx, str) else f"{int(idx):06d}"
        annos.append(get_label_anno(os.path.join(label_dir, name + ".txt")))
    return annos
