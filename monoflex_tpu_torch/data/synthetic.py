"""Synthetic data, numpy only: in-memory batches and a KITTI-format tree.

``make_train_batch`` gives every field of
``monoflex_tpu.data.synthetic.make_dummy_batch`` (which cannot be imported
here: its package pulls in jax), drawing the same numbers in the same order,
so for the same seed and sizes the arrays are identical and the port and the
JAX package can be driven with the same batch.  ``make_inference_batch`` is
its subset that inference reads.  ``make_synthetic_kitti`` writes a KITTI
tree on disk (images, labels, calibrations, ImageSets), a copy of the
repository's test fixture ``tests/synthetic_kitti.py``: the same seed gives
the same files.
"""

from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np
from PIL import Image

INFERENCE_FIELDS = ("image", "edge_indices", "edge_len", "calib_params", "pad_size",
                    "img_size")


def make_train_batch(batch_size: int, input_height: int = 384, input_width: int = 1280,
                     max_objs: int = 40, num_classes: int = 3, num_bins: int = 4,
                     n_valid: int = 3, seed: int = 0,
                     down_ratio: int = 4) -> Dict[str, np.ndarray]:
    """A physically plausible fake batch with the training field set:
    ``n_valid`` objects per image with their heatmap peaks, boxes, keypoints,
    dimensions, locations and orientation bins, the boundary chain for edge
    fusion, and the camera."""
    rng = np.random.RandomState(seed)
    out_h, out_w = input_height // down_ratio, input_width // down_ratio
    B, M = batch_size, max_objs

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
        for i in range(min(n_valid, M)):
            cx = int(rng.randint(2, max(3, out_w - 2)))
            cy = int(rng.randint(2, max(3, out_h - 2)))
            centers[b, i] = (cx, cy)
            hm[b, cy, cx, i % num_classes] = 1.0
            reg_mask[b, i] = 1.0
            cls_ids[b, i] = i % num_classes
            boxes[b, i] = (cx - 5, cy - 3, cx + 5, cy + 3)
            kpts[b, i, :, :2] = rng.randn(10, 2).astype(np.float32)
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

    calib = np.tile(np.array([[721.54, 721.54, input_width / 2, input_height / 2,
                               0.0, 0.0]], dtype=np.float32), (B, 1))
    P = np.zeros((B, 3, 4), dtype=np.float32)
    P[:, 0, 0] = 721.54
    P[:, 1, 1] = 721.54
    P[:, 0, 2] = input_width / 2
    P[:, 1, 2] = input_height / 2
    P[:, 2, 2] = 1.0

    return {
        "image": rng.randint(0, 256, (B, input_height, input_width, 3)).astype(np.uint8),
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
        "img_size": np.tile(np.array([[input_width, input_height]], dtype=np.float32), (B, 1)),
        "edge_indices": edge_indices,
        "edge_len": np.full((B,), chain_len, dtype=np.int32),
        "image_id": np.arange(B, dtype=np.int32),
    }


def make_inference_batch(batch_size: int, input_height: int = 384,
                         input_width: int = 1280, down_ratio: int = 4,
                         max_objs: int = 40, n_valid: int = 3,
                         seed: int = 0) -> Dict[str, np.ndarray]:
    """uint8 NHWC images plus the edge chain and camera fields decode needs."""
    batch = make_train_batch(batch_size, input_height, input_width, max_objs=max_objs,
                             n_valid=n_valid, seed=seed, down_ratio=down_ratio)
    return {k: batch[k] for k in INFERENCE_FIELDS}


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

IMG_W, IMG_H = 1242, 375


def _label_line(cls, trunc, occ, box2d, h, w, l, t, ry):
    alpha = ry - math.atan2(t[0], t[2])
    while alpha > math.pi:
        alpha -= 2 * math.pi
    while alpha < -math.pi:
        alpha += 2 * math.pi
    return (f"{cls} {trunc:.2f} {occ} {alpha:.2f} "
            f"{box2d[0]:.2f} {box2d[1]:.2f} {box2d[2]:.2f} {box2d[3]:.2f} "
            f"{h:.2f} {w:.2f} {l:.2f} {t[0]:.2f} {t[1]:.2f} {t[2]:.2f} {ry:.2f}")


def project_corners(P, t, h, w, l, ry):
    """8 corner (u, v) + camera-frame depth per corner (KITTI convention:
    t is the BOTTOM center; corners 0,1,4,5 are the +x heading face)."""
    x_c = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
    y_c = np.array([0.0, 0, 0, 0, -h, -h, -h, -h])
    z_c = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
    c, s = math.cos(ry), math.sin(ry)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    corners = (R @ np.stack([x_c, y_c, z_c])).T + np.asarray(t)
    hom = np.hstack([corners, np.ones((8, 1))])
    uvz = hom @ P.T
    uv = uvz[:, :2] / uvz[:, 2:3]
    return uv, corners[:, 2]


def project_box(P, t, h, w, l, ry, img_w=IMG_W, img_h=IMG_H):
    uv, _ = project_corners(P, t, h, w, l, ry)
    return np.array([
        max(uv[:, 0].min(), 0), max(uv[:, 1].min(), 0),
        min(uv[:, 0].max(), img_w - 1), min(uv[:, 1].max(), img_h - 1),
    ])


SCENES = {
    # frame 0: two cars + pedestrian, all inside
    "000000": [
        ("Car", 0.0, 0, 1.5, 1.6, 3.9, (2.0, 1.65, 15.0), 0.1),
        ("Car", 0.0, 1, 1.6, 1.7, 4.2, (-5.0, 1.7, 30.0), -1.2),
        ("Pedestrian", 0.0, 0, 1.8, 0.6, 0.8, (0.5, 1.6, 10.0), 0.5),
    ],
    # frame 1: truncated car (center projects off the left edge) + cyclist + van (ignored)
    "000001": [
        ("Car", 0.4, 0, 1.5, 1.7, 4.0, (-7.6, 1.7, 8.5), 0.0),
        ("Cyclist", 0.0, 0, 1.7, 0.6, 1.8, (3.0, 1.6, 20.0), -0.4),
        ("Van", 0.0, 0, 2.2, 1.9, 5.0, (1.0, 1.8, 25.0), 0.0),
    ],
    # frame 2: empty scene (DontCare only)
    "000002": [],
}


_CLASS_LOOK = {
    # (base RGB, dims mean (h, w, l), dims jitter)
    "Car": ((70, 90, 200), (1.55, 1.65, 3.9), 0.12),
    "Pedestrian": ((200, 80, 70), (1.75, 0.6, 0.8), 0.08),
    "Cyclist": ((80, 190, 90), (1.75, 0.6, 1.75), 0.08),
    "Van": ((150, 150, 60), (2.2, 1.9, 5.0), 0.1),
}


def _random_scene(rng, n_obj):
    """Random objects with class-dependent dims at plausible depths.  Depths
    biased near (more pixels per object) and positions rejection-sampled so
    objects rarely fully occlude each other."""
    objs = []
    placed = []  # (u_angle, z)
    for _ in range(n_obj):
        cls = ["Car", "Car", "Car", "Pedestrian", "Cyclist"][rng.randint(5)]
        _, (mh, mw, ml), jit = _CLASS_LOOK[cls]
        h = mh * float(np.exp(rng.randn() * jit))
        w = mw * float(np.exp(rng.randn() * jit))
        l = ml * float(np.exp(rng.randn() * jit))
        for _try in range(20):
            z = 7.0 + 31.0 * float(rng.uniform()) ** 1.4
            x = float(rng.uniform(-0.45, 0.45)) * z
            u = x / z
            if all(abs(u - pu) > 0.12 or abs(z - pz) > 8.0 for pu, pz in placed):
                break
        placed.append((u, z))
        y = float(rng.uniform(1.4, 1.9))
        ry = float(rng.uniform(-math.pi, math.pi))
        objs.append((cls, 0.0, 0, h, w, l, (x, y, z), ry))
    # sort far -> near so nearer objects paint over farther ones
    objs.sort(key=lambda o: -o[6][2])
    return objs


# cuboid faces as corner-index quads (0,1,4,5 = +x heading face) with a
# per-face brightness factor: heading face brightest, so yaw is visually
# observable — flat-patch rendering left orientation (and hence 3D/BEV AP)
# unlearnable
_FACES = [
    ((2, 3, 7, 6), 0.45),   # -x rear
    ((0, 3, 7, 4), 0.95),   # +z side
    ((1, 2, 6, 5), 0.70),   # -z side
    ((4, 5, 6, 7), 1.15),   # top
    ((0, 1, 5, 4), 1.50),   # +x heading face
]


def _render_scene(img, objs, p2, img_w, img_h, rng):
    """Paint each object as a shaded 3D cuboid: per-face painter's algorithm
    (far faces first), heading face brightest, corner dots.  Gives a conv net
    visual access to class (color), depth (apparent size + depth shading),
    dimensions (face extents), orientation (face shading asymmetry), and the
    10 keypoints MonoFlex regresses (visible cuboid corners)."""
    from PIL import ImageDraw

    im = Image.fromarray(img)
    draw = ImageDraw.Draw(im)
    for cls, _, _, h, w, l, t, ry in objs:
        if t[2] < 1.0:
            continue
        uv, depth = project_corners(p2, t, h, w, l, ry)
        if not np.all(np.isfinite(uv)):
            continue
        color = np.array(_CLASS_LOOK[cls][0], dtype=np.float32)
        shade = np.clip(1.25 - t[2] / 55.0, 0.4, 1.0)
        # painter's: sort faces far -> near so nearer faces overdraw
        order = sorted(_FACES, key=lambda f: -float(np.mean(depth[list(f[0])])))
        for quad, factor in order:
            pts = [tuple(uv[i]) for i in quad]
            c = tuple(int(v) for v in np.clip(color * shade * factor, 0, 255))
            draw.polygon(pts, fill=c)
        # bright corner dots on the top face + heading edge marker
        for i in (4, 5, 6, 7):
            u, v = uv[i]
            draw.ellipse([u - 0.7, v - 0.7, u + 0.7, v + 0.7], fill=(255, 255, 255))
        draw.line([tuple(uv[0]), tuple(uv[1])], fill=(255, 255, 0), width=1)
    out = np.asarray(im, dtype=np.float32)
    out = np.clip(out + rng.randn(img_h, img_w, 3) * 5.0, 0, 255)
    return out.astype(np.uint8)


def make_synthetic_kitti(root: str, frames=None, seed: int = 0, scale: int = 1,
                         n_random_frames: int = 0, render: bool = False):
    """scale > 1 shrinks images and intrinsics by that factor (tiny fast sets).

    n_random_frames > 0 appends randomized frames (2-6 objects each) after the
    3 fixed fixture frames; render=True paints class-colored patches at the
    projected boxes so models can actually LEARN from the set (used by the
    synthetic convergence run, tools/convergence_run.py)."""
    frames = frames or list(SCENES.keys())
    rng = np.random.RandomState(seed)
    scenes = dict(SCENES)
    for i in range(n_random_frames):
        name = f"{100 + i:06d}"
        scenes[name] = _random_scene(rng, 2 + rng.randint(5))
        frames = list(frames) + [name]
    for sub in ["image_2", "image_3", "label_2", "calib", "ImageSets"]:
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    img_w, img_h = IMG_W // scale, IMG_H // scale
    p2 = P2.copy()
    p3 = P3.copy()
    p2[:2] /= scale
    p3[:2] /= scale

    for frame in frames:
        if render:
            # muted gray road/sky backdrop + noise
            img = np.full((img_h, img_w, 3), 120, np.float32)
            img[: img_h // 2] += 40.0
            img = np.clip(img + rng.randn(img_h, img_w, 3) * 8.0, 0, 255).astype(np.uint8)
            img = _render_scene(img, scenes.get(frame, []), p2, img_w, img_h, rng)
        else:
            img = (rng.rand(img_h, img_w, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, "image_2", frame + ".png"))
        Image.fromarray(img[:, ::-1]).save(os.path.join(root, "image_3", frame + ".png"))

        lines = []
        for cls, trunc, occ, h, w, l, t, ry in scenes.get(frame, []):
            box2d = project_box(p2, t, h, w, l, ry, img_w, img_h)
            lines.append(_label_line(cls, trunc, occ, box2d, h, w, l, t, ry))
        lines.append("DontCare -1 -1 -10 100.0 150.0 120.0 180.0 -1 -1 -1 -1000 -1000 -1000 -10")
        with open(os.path.join(root, "label_2", frame + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

        def fmt(M):
            return " ".join(f"{v:.12e}" for v in np.asarray(M).reshape(-1))

        with open(os.path.join(root, "calib", frame + ".txt"), "w") as f:
            f.write(f"P0: {fmt(p2)}\nP1: {fmt(p2)}\nP2: {fmt(p2)}\nP3: {fmt(p3)}\n")
            f.write(f"R0_rect: {fmt(R0)}\nTr_velo_to_cam: {fmt(V2C)}\n")
            f.write(f"Tr_imu_to_velo: {fmt(V2C)}\n")

    if n_random_frames > 0:
        # held-out val split: last 20% of the random frames (the 3 fixed
        # fixture frames always train)
        n_val = max(1, n_random_frames // 5)
        split_map = {"train": frames[:-n_val], "val": frames[-n_val:],
                     "trainval": frames, "test": frames[-n_val:]}
    else:
        split_map = {s: frames for s in ["train", "val", "trainval", "test"]}
    for split, names in split_map.items():
        with open(os.path.join(root, "ImageSets", split + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root
