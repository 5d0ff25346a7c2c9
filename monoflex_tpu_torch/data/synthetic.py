"""Synthetic inference batches, numpy only.

The inference fields of ``monoflex_tpu.data.synthetic.make_dummy_batch``
(which cannot be imported here: its package pulls in jax).  For the same seed
and sizes the arrays are identical, so the port and the JAX package can be
driven with the same batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def make_inference_batch(batch_size: int, input_height: int = 384,
                         input_width: int = 1280, down_ratio: int = 4,
                         max_objs: int = 40, n_valid: int = 3,
                         seed: int = 0) -> Dict[str, np.ndarray]:
    """uint8 NHWC images plus the edge chain and camera fields decode needs."""
    rng = np.random.RandomState(seed)
    out_h, out_w = input_height // down_ratio, input_width // down_ratio
    B = batch_size
    # the JAX batch maker draws its fake objects before the image; draw the
    # same numbers in the same order so the images agree
    for _ in range(B):
        for _ in range(min(n_valid, max_objs)):
            rng.randint(2, max(3, out_w - 2))
            rng.randint(2, max(3, out_h - 2))
            rng.randn(10, 2)
            rng.uniform(-5, 5)
            rng.uniform(8, 40)

    # fixed-length boundary chain, E = 2 * (H/4 + W/4): left column then
    # bottom row, zero padded; edge_len counts the valid prefix
    e = 2 * (out_h + out_w)
    edge_indices = np.zeros((B, e, 2), dtype=np.int32)
    chain = [(0, y) for y in range(out_h - 1)] + [(x, out_h - 1) for x in range(out_w - 1)]
    edge_indices[:, :len(chain)] = np.asarray(chain, dtype=np.int32)
    chain_len = min(e, 2 * (out_h + out_w) - 5)

    calib = np.tile(np.array([[721.54, 721.54, input_width / 2, input_height / 2,
                               0.0, 0.0]], dtype=np.float32), (B, 1))
    return {
        "image": rng.randint(0, 256, (B, input_height, input_width, 3)).astype(np.uint8),
        "edge_indices": edge_indices,
        "edge_len": np.full((B,), chain_len, dtype=np.int32),
        "calib_params": calib,
        "pad_size": np.zeros((B, 2), dtype=np.float32),
        "img_size": np.tile(np.array([[input_width, input_height]], dtype=np.float32), (B, 1)),
    }
