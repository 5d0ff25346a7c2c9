"""KITTI label parsing (reference: data/datasets/kitti_utils.py:61-133).

Kept numpy-only and free of framework types so both the data pipeline and the
evaluator can share it.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from ..core.geometry_np import box3d_corners, convert_rot_to_alpha


class Object3d:
    """One KITTI label line."""

    def __init__(self, line: str):
        data = line.split(" ")
        vals = [float(x) for x in data[1:]]
        self.type = data[0]
        self.truncation = vals[0]
        self.occlusion = int(vals[1])
        self.real_alpha = vals[2]
        self.xmin, self.ymin, self.xmax, self.ymax = vals[3:7]
        self.box2d = np.array([self.xmin, self.ymin, self.xmax, self.ymax], dtype=np.float32)
        self.h, self.w, self.l = vals[7:10]
        self.t = np.array(vals[10:13], dtype=np.float32)  # bottom-center, rect coords
        self.ry = vals[13]
        self.score = vals[14] if len(vals) > 14 else 1.0
        self.dis_to_cam = float(np.linalg.norm(self.t))
        self.ray = math.atan2(float(self.t[0]), float(self.t[2]))
        # recompute alpha from geometry (the reference does the same instead of
        # trusting the label's alpha column)
        self.alpha = convert_rot_to_alpha(self.ry, float(self.t[2]), float(self.t[0]))
        self.level_str, self.level = self._difficulty()

    def _difficulty(self):
        """KITTI difficulty from 2D height / truncation / occlusion
        (reference: data/datasets/kitti_utils.py:99-113)."""
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            return "Easy", 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            return "Moderate", 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            return "Hard", 2
        return "UnKnown", -1

    def generate_corners3d(self) -> np.ndarray:
        return box3d_corners(np.array([self.l, self.h, self.w]), self.t, self.ry)

    def __repr__(self):
        return (f"Object3d({self.type}, t={self.t.tolist()}, lhw=({self.l},{self.h},{self.w}), "
                f"ry={self.ry:.3f})")


def read_label(path: str) -> List[Object3d]:
    with open(path, "r") as f:
        return [Object3d(line.rstrip()) for line in f if line.strip()]
