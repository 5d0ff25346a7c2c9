"""Synthetic batches, numpy only.

``make_train_batch`` gives every field of
``monoflex_tpu.data.synthetic.make_dummy_batch`` (which cannot be imported
here: its package pulls in jax), drawing the same numbers in the same order,
so for the same seed and sizes the arrays are identical and the port and the
JAX package can be driven with the same batch.  ``make_inference_batch`` is
its subset that inference reads.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

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
