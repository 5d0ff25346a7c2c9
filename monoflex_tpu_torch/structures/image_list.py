"""Batched image container with pad-to-max semantics (a copy of the JAX
package's ``structures/image_list.py``; reference:
structures/image_list.py:6-69).  Numpy: the port's loaders batch numpy
arrays and move them to the device afterwards."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class ImageList:
    def __init__(self, tensors: np.ndarray, image_sizes: List[Tuple[int, int]]):
        self.tensors = tensors            # (B, H, W, C) NHWC
        self.image_sizes = image_sizes    # original (h, w) per image

    def __len__(self) -> int:
        return self.tensors.shape[0]


def to_image_list(images: Sequence[np.ndarray],
                  size_divisibility: int = 0) -> ImageList:
    """Stack HWC images, zero-padding each to the max (optionally divisible)
    spatial size."""
    images = [np.asarray(im) for im in images]
    max_h = max(im.shape[0] for im in images)
    max_w = max(im.shape[1] for im in images)
    if size_divisibility > 0:
        d = size_divisibility
        max_h = (max_h + d - 1) // d * d
        max_w = (max_w + d - 1) // d * d
    batch = np.zeros((len(images), max_h, max_w, images[0].shape[2]),
                     dtype=images[0].dtype)
    sizes = []
    for i, im in enumerate(images):
        batch[i, : im.shape[0], : im.shape[1]] = im
        sizes.append((im.shape[0], im.shape[1]))
    return ImageList(batch, sizes)
