"""Training augmentations (reference: data/augmentations/augmentations.py:28-77).

The reference pipeline uses exactly one augmentation: random horizontal flip,
which must also mirror the labels (box2d, yaw, x-location, alpha) and the
calibration P matrix.
"""

from __future__ import annotations

import math
import random
from typing import List, Tuple

import numpy as np
from PIL import Image

from .geometry_np import Calibration, convert_rot_to_alpha
from .kitti_objects import Object3d


def flip_sample(img: Image.Image, objs: List[Object3d], calib: Calibration):
    """Horizontally flip image + labels + calibration, in place for objs/calib."""
    img = img.transpose(Image.FLIP_LEFT_RIGHT)
    img_w = img.size[0]

    for obj in objs:
        w = obj.xmax - obj.xmin
        obj.xmin = img_w - obj.xmax - 1
        obj.xmax = obj.xmin + w
        obj.box2d = np.array([obj.xmin, obj.ymin, obj.xmax, obj.ymax], dtype=np.float32)

        roty = obj.ry
        roty = (-math.pi - roty) if roty < 0 else (math.pi - roty)
        while roty > math.pi:
            roty -= 2 * math.pi
        while roty < -math.pi:
            roty += 2 * math.pi
        obj.ry = roty

        loc = obj.t.copy()
        loc[0] = -loc[0]
        obj.t = loc
        obj.alpha = convert_rot_to_alpha(roty, float(obj.t[2]), float(obj.t[0]))

    calib.flip_horizontally(img_w)
    return img, objs, calib


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, rng: random.Random | None = None):
        self.p = p
        self.rng = rng or random.Random()

    def __call__(self, img, objs, calib):
        if self.rng.random() < self.p:
            return flip_sample(img, objs, calib)
        return img, objs, calib


def build_augmentations(aug_params) -> List:
    """cfg.INPUT.AUG_PARAMS -> augmentation list; [[p_flip]] is the only entry
    the reference wires (reference: data/augmentations/__init__.py:16-24)."""
    augs = []
    if aug_params and len(aug_params[0]) > 0:
        augs.append(RandomHorizontalFlip(aug_params[0][0]))
    return augs
