"""Gaussian heatmap target rendering (host/numpy side).

Re-derivation of the CenterNet-style gaussian splat machinery
(reference: model/heatmap_coder.py:37-157).  These run inside the data
pipeline workers; the device never draws heatmaps.
"""

from __future__ import annotations

import numpy as np


def get_transform_matrix(center_scale, output_size) -> np.ndarray:
    """Affine matrix mapping a (center, scale) crop onto the output frame
    (reference: model/heatmap_coder.py:6-26, scikit-image estimate replaced by
    a closed-form 3-point solve)."""
    center, scale = np.asarray(center_scale[0]), np.asarray(center_scale[1])
    src_w, src_h = scale
    dst_w, dst_h = output_size
    src = np.array([
        center,
        center - [src_w * 0.5, 0],
        center - [0, src_h * 0.5],
    ], dtype=np.float64)
    dst = np.array([
        [dst_w * 0.5, dst_h * 0.5],
        [0, dst_h * 0.5],
        [dst_w * 0.5, 0],
    ], dtype=np.float64)
    # solve [x y 1] @ M.T = dst for the 2x3 affine M, returned 3x3
    A = np.hstack([src, np.ones((3, 1))])
    M = np.linalg.solve(A, dst).T           # (2, 3)
    return np.vstack([M, [0, 0, 1]]).astype(np.float32)


def affine_transform(point: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Apply a 3x3 affine to (N, 2) points (reference: model/heatmap_coder.py:28-35)."""
    point = np.asarray(point, dtype=np.float64).reshape(-1, 2)
    hom = np.concatenate([point, np.ones((point.shape[0], 1))], axis=1)
    out = hom @ matrix.T
    return out[:, :2].squeeze()


def gaussian_radius(height: float, width: float, min_overlap: float = 0.7) -> float:
    """Minimum radius such that any center within it keeps IoU >= min_overlap.

    The three quadratic cases follow the CornerNet derivation
    (reference: model/heatmap_coder.py:37-57).
    """
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * a1 * c1)) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 4 * a2 * c2)) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def gaussian_2d(shape, sigma: float = 1.0) -> np.ndarray:
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m: m + 1, -n: n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def ellip_gaussian_2d(shape, sigma_x: float, sigma_y: float) -> np.ndarray:
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m: m + 1, -n: n + 1]
    h = np.exp(-(x * x) / (2 * sigma_x * sigma_x) - (y * y) / (2 * sigma_y * sigma_y))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0,
                  ignore: bool = False) -> np.ndarray:
    """Max-splat a circular gaussian at ``center`` (in-place; returns heatmap).

    ``ignore=True`` marks untouched (==0) pixels in the footprint as -1 so the
    focal loss skips them (reference: model/heatmap_coder.py:95-103).
    """
    diameter = 2 * radius + 1
    gaussian = gaussian_2d((diameter, diameter), sigma=diameter / 6)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]
    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    masked_heatmap = heatmap[y - top: y + bottom, x - left: x + right]
    masked_gaussian = gaussian[radius - top: radius + bottom, radius - left: radius + right]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        if ignore:
            masked_heatmap[masked_heatmap == 0] = -1
        else:
            np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)
    return heatmap


def draw_ellip_gaussian(heatmap: np.ndarray, center, radius_x: int, radius_y: int,
                        k: float = 1.0) -> np.ndarray:
    """Elliptical (possibly degenerate 1-D) gaussian used for truncated objects
    whose approximate center sits on the image border."""
    diameter_x, diameter_y = 2 * radius_x + 1, 2 * radius_y + 1
    gaussian = ellip_gaussian_2d((diameter_y, diameter_x),
                                 sigma_x=diameter_x / 6, sigma_y=diameter_y / 6)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]
    left, right = min(x, radius_x), min(width - x, radius_x + 1)
    top, bottom = min(y, radius_y), min(height - y, radius_y + 1)

    masked_heatmap = heatmap[y - top: y + bottom, x - left: x + right]
    masked_gaussian = gaussian[radius_y - top: radius_y + bottom, radius_x - left: radius_x + right]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)
    return heatmap


def draw_gaussian_1d(edgemap: np.ndarray, center: int, radius: int) -> np.ndarray:
    """1-D gaussian along an edge heatmap row/column."""
    diameter = 2 * radius + 1
    sigma = diameter / 6
    xs = np.arange(-radius, radius + 1)
    gaussian = np.exp(-(xs * xs) / (2 * sigma * sigma))
    left, right = min(center, radius), min(len(edgemap) - center, radius + 1)
    masked_edgemap = edgemap[center - left: center + right]
    masked_gaussian = gaussian[radius - left: radius + right]
    if masked_gaussian.size > 0 and masked_edgemap.size > 0:
        np.maximum(masked_edgemap, masked_gaussian, out=masked_edgemap)
    return edgemap
