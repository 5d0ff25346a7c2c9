"""The benchmark's inputs, made from the seed (numpy and Pillow only).

Frozen copies of the port's synthetic makers, so that a change to the
program cannot change what the benchmark feeds it:

- ``train_batches``: encoded training batches with every field of
  ``monoflex_tpu_torch/data/synthetic.py::make_train_batch`` (its shapes,
  dtypes and layout), with a per-image object count;
- ``inference_batches``: their subset that forward + decode reads;
- ``write_kitti_tree``: a KITTI training tree (``image_2``, ``label_2``,
  ``calib``, ``ImageSets``) of rendered cuboid scenes, after
  ``make_synthetic_kitti(render=True)``, with KITTI's mix of classes.

Every batch and frame draws from its own generator, seeded by (seed, index),
so a pool's contents do not depend on its size and the same seed gives the
same files and arrays.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np
from PIL import Image, ImageDraw

INFERENCE_FIELDS = ("image", "edge_indices", "edge_len", "calib_params", "pad_size",
                    "img_size")


def rng_for(seed: int, *index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, *index])


def object_counts(rng: np.random.Generator, n: int, spec: Dict) -> np.ndarray:
    """``n`` object counts: ``lo`` + Poisson(``mean`` - ``lo``), clipped to
    [``lo``, ``hi``]."""
    lo, hi, mean = int(spec["min"]), int(spec["max"]), float(spec["mean"])
    return np.clip(lo + rng.poisson(mean - lo, size=n), lo, hi)


def train_batch(seed: int, index: int, batch: int, height: int, width: int,
                objects: Dict, max_objs: int = 40, num_classes: int = 3, num_bins: int = 4,
                down_ratio: int = 4) -> Dict[str, np.ndarray]:
    """One encoded training batch: ``objects`` per image (a count spec), each
    with its heatmap peak, box, keypoints, dimensions, location and
    orientation bin, the boundary chain for edge fusion and the camera."""
    rng = rng_for(seed, 1, index)
    out_h, out_w = height // down_ratio, width // down_ratio
    B, M = batch, max_objs
    counts = object_counts(rng, B, objects)

    hm = np.zeros((B, out_h, out_w, num_classes), dtype=np.float32)
    centers = np.zeros((B, M, 2), dtype=np.int32)
    reg_mask = np.zeros((B, M), dtype=np.float32)
    cls_ids = np.zeros((B, M), dtype=np.int32)
    boxes = np.zeros((B, M, 4), dtype=np.float32)
    kpts = np.zeros((B, M, 10, 3), dtype=np.float32)
    dims = np.ones((B, M, 3), dtype=np.float32)
    locs = np.zeros((B, M, 3), dtype=np.float32)
    oris = np.zeros((B, M, num_bins * 2), dtype=np.float32)
    for b in range(B):
        for i in range(min(int(counts[b]), M)):
            cx = int(rng.integers(2, max(3, out_w - 2)))
            cy = int(rng.integers(2, max(3, out_h - 2)))
            centers[b, i] = (cx, cy)
            hm[b, cy, cx, i % num_classes] = 1.0
            reg_mask[b, i] = 1.0
            cls_ids[b, i] = i % num_classes
            boxes[b, i] = (cx - 5, cy - 3, cx + 5, cy + 3)
            kpts[b, i, :, :2] = rng.standard_normal((10, 2), dtype=np.float32)
            kpts[b, i, :, 2] = 1.0
            dims[b, i] = (3.9, 1.5, 1.6)
            locs[b, i] = (rng.uniform(-5, 5), 1.6, rng.uniform(8, 40))
            oris[b, i, 0] = 1.0

    # fixed-length boundary chain, E = 2 * (H/4 + W/4): left column then
    # bottom row, zero padded; edge_len counts the valid prefix
    e = 2 * (out_h + out_w)
    edge_indices = np.zeros((B, e, 2), dtype=np.int32)
    chain = [(0, y) for y in range(out_h - 1)] + [(x, out_h - 1) for x in range(out_w - 1)]
    edge_indices[:, :len(chain)] = np.asarray(chain, dtype=np.int32)
    chain_len = min(e, 2 * (out_h + out_w) - 5)

    calib = np.tile(np.array([[721.54, 721.54, width / 2, height / 2, 0.0, 0.0]],
                             dtype=np.float32), (B, 1))
    P = np.zeros((B, 3, 4), dtype=np.float32)
    P[:, 0, 0] = 721.54
    P[:, 1, 1] = 721.54
    P[:, 0, 2] = width / 2
    P[:, 1, 2] = height / 2
    P[:, 2, 2] = 1.0
    return {
        "image": rng.integers(0, 256, (B, height, width, 3), dtype=np.uint8),
        "hm": hm,
        "cls_ids": cls_ids,
        "target_centers": centers,
        "2d_bboxes": boxes,
        "gt_bboxes": boxes.copy(),
        "keypoints": kpts,
        "keypoints_depth_mask": np.ones((B, M, 3), dtype=np.float32) * reg_mask[..., None],
        "dimensions": dims,
        "locations": locs,
        "rotys": np.zeros((B, M), dtype=np.float32),
        "alphas": np.zeros((B, M), dtype=np.float32),
        "offset_3D": np.zeros((B, M, 2), dtype=np.float32),
        "orientations": oris,
        "reg_mask": reg_mask,
        "trunc_mask": np.zeros((B, M), dtype=np.float32),
        "reg_weight": reg_mask.copy(),
        "occlusions": np.zeros((B, M), dtype=np.float32),
        "truncations": np.zeros((B, M), dtype=np.float32),
        "pad_size": np.zeros((B, 2), dtype=np.float32),
        "calib_params": calib,
        "calib_P": P,
        "img_size": np.tile(np.array([[width, height]], dtype=np.float32), (B, 1)),
        "edge_indices": edge_indices,
        "edge_len": np.full((B,), chain_len, dtype=np.int32),
        "image_id": (index * B + np.arange(B)).astype(np.int32),
    }


def train_batches(seed: int, n: int, **kw) -> List[Dict[str, np.ndarray]]:
    return [train_batch(seed, i, **kw) for i in range(n)]


def inference_batches(seed: int, n: int, **kw) -> List[Dict[str, np.ndarray]]:
    """``n`` batches of the fields forward + decode reads (uint8 NHWC images
    in host memory, the edge chain and the camera)."""
    return [{k: v for k, v in train_batch(seed, i, **kw).items() if k in INFERENCE_FIELDS}
            for i in range(n)]


# ---------------------------------------------------------------------------
# the KITTI tree: KITTI's camera, image size and label format

P2 = np.array([
    [721.5377, 0.0, 609.5593, 44.85728],
    [0.0, 721.5377, 172.854, 0.2163791],
    [0.0, 0.0, 1.0, 0.002745884],
])
P3 = np.array([
    [721.5377, 0.0, 609.5593, -339.5242],
    [0.0, 721.5377, 172.854, 2.199936],
    [0.0, 0.0, 1.0, 0.002745884],
])
R0 = np.eye(3)
V2C = np.array([[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, -0.08], [1.0, 0.0, 0.0, -0.27]])

# (base RGB, mean (h, w, l), log-normal jitter)
CLASS_LOOK = {
    "Car": ((70, 90, 200), (1.55, 1.65, 3.9), 0.12),
    "Pedestrian": ((200, 80, 70), (1.75, 0.6, 0.8), 0.08),
    "Cyclist": ((80, 190, 90), (1.75, 0.6, 1.75), 0.08),
}
# cuboid faces as corner-index quads (0,1,4,5 = +x heading face), brightness
FACES = (((2, 3, 7, 6), 0.45), ((0, 3, 7, 4), 0.95), ((1, 2, 6, 5), 0.70),
         ((4, 5, 6, 7), 1.15), ((0, 1, 5, 4), 1.50))


def project_corners(P, t, h, w, l, ry):
    """8 corner (u, v) and the camera-frame depth of each (KITTI: t is the
    bottom centre; corners 0,1,4,5 are the +x heading face)."""
    x_c = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
    y_c = np.array([0.0, 0, 0, 0, -h, -h, -h, -h])
    z_c = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
    c, s = math.cos(ry), math.sin(ry)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    corners = (R @ np.stack([x_c, y_c, z_c])).T + np.asarray(t)
    uvz = np.hstack([corners, np.ones((8, 1))]) @ P.T
    return uvz[:, :2] / uvz[:, 2:3], corners[:, 2]


def random_scene(rng: np.random.Generator, n_obj: int, class_shares: Dict[str, float]):
    """``n_obj`` objects with class-dependent sizes at plausible depths,
    placed so that they rarely hide each other; far to near."""
    names = list(class_shares)
    p = np.asarray([class_shares[k] for k in names], dtype=np.float64)
    objs, placed = [], []
    for _ in range(n_obj):
        cls = names[int(rng.choice(len(names), p=p / p.sum()))]
        _, (mh, mw, ml), jit = CLASS_LOOK[cls]
        h, w, l = (m * float(np.exp(rng.standard_normal() * jit)) for m in (mh, mw, ml))
        for _try in range(20):
            z = 7.0 + 31.0 * float(rng.uniform()) ** 1.4
            x = float(rng.uniform(-0.45, 0.45)) * z
            if all(abs(x / z - pu) > 0.12 or abs(z - pz) > 8.0 for pu, pz in placed):
                break
        placed.append((x / z, z))
        ry = float(rng.uniform(-math.pi, math.pi))
        objs.append((cls, h, w, l, (x, float(rng.uniform(1.4, 1.9)), z), ry))
    objs.sort(key=lambda o: -o[4][2])
    return objs


def render(rng: np.random.Generator, objs, width: int, height: int) -> np.ndarray:
    """A grey road and sky with noise, each object a shaded cuboid (far
    faces first, heading face brightest) with its top corners marked."""
    img = np.full((height, width, 3), 120, np.float32)
    img[: height // 2] += 40.0
    im = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(im)
    for cls, h, w, l, t, ry in objs:
        uv, depth = project_corners(P2, t, h, w, l, ry)
        if not np.all(np.isfinite(uv)):
            continue
        color = np.array(CLASS_LOOK[cls][0], dtype=np.float32)
        shade = np.clip(1.25 - t[2] / 55.0, 0.4, 1.0)
        for quad, factor in sorted(FACES, key=lambda f: -float(np.mean(depth[list(f[0])]))):
            draw.polygon([tuple(uv[i]) for i in quad],
                         fill=tuple(int(v) for v in np.clip(color * shade * factor, 0, 255)))
        for i in (4, 5, 6, 7):
            u, v = uv[i]
            draw.ellipse([u - 0.7, v - 0.7, u + 0.7, v + 0.7], fill=(255, 255, 255))
        draw.line([tuple(uv[0]), tuple(uv[1])], fill=(255, 255, 0), width=1)
    noise = rng.standard_normal((height, width, 3), dtype=np.float32) * 8.0
    return np.clip(np.asarray(im, dtype=np.float32) + noise, 0, 255).astype(np.uint8)


def label_line(cls, box2d, h, w, l, t, ry) -> str:
    alpha = ry - math.atan2(t[0], t[2])
    alpha = (alpha + math.pi) % (2 * math.pi) - math.pi
    return (f"{cls} 0.00 0 {alpha:.2f} {box2d[0]:.2f} {box2d[1]:.2f} {box2d[2]:.2f} "
            f"{box2d[3]:.2f} {h:.2f} {w:.2f} {l:.2f} {t[0]:.2f} {t[1]:.2f} {t[2]:.2f} {ry:.2f}")


def _fmt(M) -> str:
    return " ".join(f"{v:.12e}" for v in np.asarray(M).reshape(-1))


CALIB = (f"P0: {_fmt(P2)}\nP1: {_fmt(P2)}\nP2: {_fmt(P2)}\nP3: {_fmt(P3)}\n"
         f"R0_rect: {_fmt(R0)}\nTr_velo_to_cam: {_fmt(V2C)}\nTr_imu_to_velo: {_fmt(V2C)}\n")


def write_frame(root: str, name: str, seed: int, index: int, width: int, height: int,
                objects: Dict, class_shares: Dict[str, float]) -> int:
    """Render, label and calibrate one frame; returns its object count."""
    rng = rng_for(seed, 2, index)
    n_obj = int(object_counts(rng, 1, objects)[0])
    objs = random_scene(rng, n_obj, class_shares)
    Image.fromarray(render(rng, objs, width, height)).save(
        os.path.join(root, "image_2", name + ".png"))
    lines = []
    for cls, h, w, l, t, ry in objs:
        uv, _ = project_corners(P2, t, h, w, l, ry)
        box2d = (max(uv[:, 0].min(), 0), max(uv[:, 1].min(), 0),
                 min(uv[:, 0].max(), width - 1), min(uv[:, 1].max(), height - 1))
        lines.append(label_line(cls, box2d, h, w, l, t, ry))
    lines.append("DontCare -1 -1 -10 100.0 150.0 120.0 180.0 -1 -1 -1 -1000 -1000 -1000 -10")
    with open(os.path.join(root, "label_2", name + ".txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "calib", name + ".txt"), "w") as f:
        f.write(CALIB)
    return n_obj


def write_kitti_tree(root: str, seed: int, frames: int, width: int, height: int,
                     objects: Dict, class_shares: Dict[str, float],
                     splits: Sequence[str] = ("train", "val"), workers: int = 8) -> List[int]:
    """``frames`` rendered frames under ``root`` (a KITTI ``training``
    directory), every split listing all of them; returns the object count of
    each frame."""
    for sub in ("image_2", "label_2", "calib", "ImageSets"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = [f"{i:06d}" for i in range(frames)]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        counts = list(pool.map(
            lambda i: write_frame(root, names[i], seed, i, width, height, objects,
                                  class_shares), range(frames)))
    for split in splits:
        with open(os.path.join(root, "ImageSets", split + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return counts
