"""Camera geometry for KITTI monocular 3D detection (host/numpy side).

Pure-numpy re-derivations of the reference geometry codecs:
  - Calibration / projections      (reference: data/datasets/kitti_utils.py:160-394)
  - alpha <-> rotation_y           (reference: data/datasets/kitti_utils.py:31-49)
  - 3D box corners                 (reference: data/datasets/kitti_utils.py:115-133)
  - truncated-object approx center (reference: data/datasets/kitti_utils.py:990-1028)
  - multibin orientation encoding  (reference: data/datasets/kitti.py:181-200)

A copy of ``monoflex_tpu/core/geometry.py``; the port's device-side
counterparts are in ``geometry.py`` beside it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

PI = math.pi


def convert_rot_to_alpha(ry: float, z3d: float, x3d: float) -> float:
    """Global yaw -> observation angle, wrapped to [-pi, pi]."""
    alpha = ry - math.atan2(x3d, z3d)
    while alpha > PI:
        alpha -= 2 * PI
    while alpha < -PI:
        alpha += 2 * PI
    return alpha


def convert_alpha_to_rot(alpha: float, z3d: float, x3d: float) -> float:
    """Observation angle -> global yaw (note the reference's +pi/2 variant is
    only used by its unused utilities; detection decode uses ry = alpha + ray)."""
    ry = alpha + math.atan2(x3d, z3d)
    while ry > PI:
        ry -= 2 * PI
    while ry < -PI:
        ry += 2 * PI
    return ry


def roty_matrix(ry: float) -> np.ndarray:
    c, s = math.cos(ry), math.sin(ry)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def box3d_corners(dim_lhw: np.ndarray, location: np.ndarray, ry: float) -> np.ndarray:
    """(8, 3) corners in rect camera coords.

    ``location`` is the KITTI label location = bottom face center; corner order
    matches the reference: bottom face first (y=0 plane), then top (y=-h).
    """
    l, h, w = float(dim_lhw[0]), float(dim_lhw[1]), float(dim_lhw[2])
    x_c = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
    y_c = np.array([0.0, 0.0, 0.0, 0.0, -h, -h, -h, -h])
    z_c = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
    corners = roty_matrix(ry) @ np.stack([x_c, y_c, z_c])
    return corners.T + np.asarray(location).reshape(1, 3)


class Calibration:
    """KITTI camera calibration (P2 by default, P3 for the right camera)."""

    def __init__(self, P: np.ndarray, R0: Optional[np.ndarray] = None,
                 V2C: Optional[np.ndarray] = None):
        self.P = np.asarray(P, dtype=np.float64).reshape(3, 4)
        self.R0 = np.eye(3) if R0 is None else np.asarray(R0).reshape(3, 3)
        self.V2C = np.zeros((3, 4)) if V2C is None else np.asarray(V2C).reshape(3, 4)
        self.refresh()

    def refresh(self) -> None:
        """Re-derive intrinsics after P is mutated (e.g. by a horizontal flip)."""
        self.c_u = self.P[0, 2]
        self.c_v = self.P[1, 2]
        self.f_u = self.P[0, 0]
        self.f_v = self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

    @classmethod
    def from_kitti_file(cls, path: str, use_right_cam: bool = False) -> "Calibration":
        data = {}
        with open(path, "r") as f:
            for line in f:
                line = line.rstrip()
                if not line or ":" not in line:
                    continue
                key, value = line.split(":", 1)
                try:
                    data[key] = np.array([float(x) for x in value.split()])
                except ValueError:
                    pass
        P = data["P3"] if use_right_cam else data["P2"]
        return cls(P, data.get("R0_rect"), data.get("Tr_velo_to_cam"))

    def project_rect_to_image(self, pts_3d: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(N, 3) rect coords -> ((N, 2) pixels, (N,) depth)."""
        pts_3d = np.asarray(pts_3d, dtype=np.float64).reshape(-1, 3)
        hom = np.hstack([pts_3d, np.ones((pts_3d.shape[0], 1))])
        uvz = hom @ self.P.T
        uv = uvz[:, :2] / uvz[:, 2:3]
        return uv, uvz[:, 2]

    def project_image_to_rect(self, uv_depth: np.ndarray) -> np.ndarray:
        """(N, 3) [u, v, depth] -> (N, 3) rect coords."""
        uv_depth = np.asarray(uv_depth, dtype=np.float64).reshape(-1, 3)
        x = (uv_depth[:, 0] - self.c_u) * uv_depth[:, 2] / self.f_u + self.b_x
        y = (uv_depth[:, 1] - self.c_v) * uv_depth[:, 2] / self.f_v + self.b_y
        return np.stack([x, y, uv_depth[:, 2]], axis=1)

    def flip_horizontally(self, img_w: int) -> None:
        """Mirror the projection matrix for a horizontally flipped image
        (reference: data/augmentations/augmentations.py:69-74)."""
        P = self.P.copy()
        P[0, 2] = img_w - P[0, 2] - 1
        P[0, 3] = -P[0, 3]
        self.P = P
        self.refresh()

    def as_params(self) -> np.ndarray:
        """Pack the intrinsics the device-side decode needs: [f_u f_v c_u c_v b_x b_y]."""
        return np.array([self.f_u, self.f_v, self.c_u, self.c_v, self.b_x, self.b_y],
                        dtype=np.float32)


def approx_proj_center(proj_center: np.ndarray, surface_centers: np.ndarray,
                       img_size: Tuple[int, int]):
    """Approximate an outside-image projected 3D center by intersecting the
    line (proj_center -> 2D box center) with the image border and taking the
    intersection closest to the true projected center.

    Returns (approx_center (2,), edge_index) or None if the 2D box center is
    itself outside the image.
    """
    img_w, img_h = img_size
    surface_centers = np.asarray(surface_centers).reshape(-1, 2)
    inside = (
        (surface_centers[:, 0] >= 0) & (surface_centers[:, 1] >= 0)
        & (surface_centers[:, 0] <= img_w - 1) & (surface_centers[:, 1] <= img_h - 1)
    )
    if inside.sum() == 0:
        return None
    target = surface_centers[int(np.argmax(inside))]

    dx = target[0] - proj_center[0]
    dy = target[1] - proj_center[1]
    if abs(dx) < 1e-12:
        # vertical line: only top/bottom borders can intersect
        a = math.inf
        b = math.nan
        candidates = []
        x = proj_center[0]
        if 0 <= x <= img_w - 1:
            candidates.append((np.array([x, 0.0]), 2))
            candidates.append((np.array([x, img_h - 1.0]), 3))
    else:
        a = dy / dx
        b = proj_center[1] - a * proj_center[0]
        candidates = []
        left_y = b
        if 0 <= left_y <= img_h - 1:
            candidates.append((np.array([0.0, left_y]), 0))
        right_y = (img_w - 1) * a + b
        if 0 <= right_y <= img_h - 1:
            candidates.append((np.array([img_w - 1.0, right_y]), 1))
        if abs(a) > 1e-12:
            top_x = -b / a
            if 0 <= top_x <= img_w - 1:
                candidates.append((np.array([top_x, 0.0]), 2))
            bottom_x = (img_h - 1 - b) / a
            if 0 <= bottom_x <= img_w - 1:
                candidates.append((np.array([bottom_x, img_h - 1.0]), 3))
    if not candidates:
        return None
    pts = np.stack([c[0] for c in candidates])
    dists = np.linalg.norm(pts - np.asarray(proj_center).reshape(1, 2), axis=1)
    idx = int(np.argmin(dists))
    return candidates[idx][0], candidates[idx][1]


# Multibin orientation -------------------------------------------------------

ALPHA_CENTERS = np.array([0.0, PI / 2, PI, -PI / 2])


def encode_alpha_multibin(alpha: float, num_bin: int = 4, margin: float = 1 / 6) -> np.ndarray:
    """alpha -> [bin_cls(num_bin), bin_offset(num_bin)].

    A bin is active when |wrap(alpha - center)| < bin_size/2 + margin*bin_size;
    active bins store the wrapped offset.
    """
    encoded = np.zeros(num_bin * 2, dtype=np.float32)
    bin_size = 2 * PI / num_bin
    range_size = bin_size / 2 + bin_size * margin

    offsets = alpha - ALPHA_CENTERS[:num_bin]
    offsets = np.where(offsets > PI, offsets - 2 * PI, offsets)
    offsets = np.where(offsets < -PI, offsets + 2 * PI, offsets)

    for i in range(num_bin):
        if abs(offsets[i]) < range_size:
            encoded[i] = 1
            encoded[i + num_bin] = offsets[i]
    return encoded


def decode_alpha_multibin(vector_ori: np.ndarray, num_bin: int = 4) -> float:
    """Inverse of the network's multibin head output (numpy oracle for tests).

    vector_ori: [cls logits (2*num_bin), sin/cos offsets (2*num_bin)].
    """
    logits = vector_ori[: num_bin * 2].reshape(num_bin, 2)
    exp = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = exp / exp.sum(axis=1, keepdims=True)
    best = int(np.argmax(probs[:, 1]))
    s = num_bin * 2 + best * 2
    sin_v, cos_v = vector_ori[s], vector_ori[s + 1]
    alpha = math.atan2(sin_v, cos_v) + ALPHA_CENTERS[best]
    return alpha
