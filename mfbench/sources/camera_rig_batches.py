"""A seeded host pool of ``pool`` samples of a camera rig: each sample one
uint8 image (height x width, RGB) per camera of the mix's ``cameras``, in
that order, and each camera's intrinsics (``cam_intrinsic``, (cameras, 3,
3) float32), cycled in order.

An image is a street-like scene drawn from the seed: a sky-to-ground
gradient, a coarse colour field (an 8x14 grid upsampled), 4-12 boxes of flat
colour (vehicles and walls at random places and sizes), and pixel noise,
so that its maps vary in space as a photograph's do.  Made in bulk with
torch on the host; a pool's first samples do not depend on its size."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from mfbench.sources import Feed


def intrinsics(cameras: List[Dict]) -> np.ndarray:
    return np.array([[[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]], [0.0, 0.0, 1.0]]
                     for c in cameras], dtype=np.float32)


def render(rng: np.random.Generator, n: int, height: int, width: int) -> np.ndarray:
    """``n`` scenes (n, height, width, 3) uint8 (module docstring)."""
    rows = torch.linspace(0, 1, height).view(1, 1, height, 1)
    sky = torch.from_numpy(rng.uniform(120, 230, (n, 3, 1, 1))).float()
    ground = torch.from_numpy(rng.uniform(30, 110, (n, 3, 1, 1))).float()
    img = sky * (1 - rows) + ground * rows
    coarse = torch.from_numpy(rng.normal(0, 35, (n, 3, 8, 14))).float()
    img = img + F.interpolate(coarse, size=(height, width), mode="bilinear", align_corners=False)
    for k in range(n):
        for _ in range(int(rng.integers(4, 13))):
            h = int(rng.uniform(0.05, 0.4) * height)
            w = int(rng.uniform(0.04, 0.3) * width)
            y = int(rng.uniform(0.3, 0.95) * height) - h // 2
            x = int(rng.integers(0, max(1, width - w)))
            colour = torch.from_numpy(rng.uniform(0, 255, (3, 1, 1))).float()
            img[k, :, max(0, y):y + h, x:x + w] = colour
    g = torch.Generator().manual_seed(int(rng.integers(2 ** 62)))
    img += torch.randn((n, 1, height, width), generator=g) * 6
    img = img.clamp_(0, 255).round_().to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous().numpy()


def samples(seed: int, pool: int, cameras: List[Dict], height: int, width: int) -> List[Dict]:
    cam = intrinsics(cameras)
    out = []
    for i in range(pool):
        rng = np.random.default_rng([int(seed) % 2 ** 64, 17, i])
        out.append({"image": render(rng, len(cameras), height, width), "cam_intrinsic": cam})
    return out


def make(traffic, shape, seed, prog, cfg, scratch) -> Feed:
    cameras = traffic["cameras"][:shape["batch"]]
    if len(cameras) < shape["batch"]:
        cameras = (cameras * shape["batch"])[:shape["batch"]]
    pool = samples(seed, traffic["pool"], cameras, shape["height"], shape["width"])
    return Feed(next=lambda i: pool[i % len(pool)], steps_per_epoch=len(pool), pool=pool)
