"""Samples of a six-camera rig driven through scenes, in scene order, from
the seed: ``next(i)`` is the i-th sample {"image" (cameras, height, width,
3) uint8, "lidar2img" (cameras, 4, 4) float32, "can_bus" (18,) float32,
"scene_start" (1,) bool}.

- Images: a host pool of ``pool`` image sets (``camera_rig_batches.render``'s
  street-like scenes), sample i taking set i % pool.
- Cameras: the mix's ``cameras`` (intrinsics at 1600 x 900, scaled to the
  run's size; yaw left of forward), mounted ``mount`` metres out from the
  lidar along their axis and ``mount_down`` below it, in the lidar frame of
  nuScenes (x right, y forward, z up); ``lidar2img`` = K @ lidar2cam, the
  same for every sample.
- Motion: scene s = i // ``scene_samples``, sample k = i % ``scene_samples``
  of it, ``dt`` seconds apart.  The seed draws each scene's start (a
  global position within 1 km, a heading), its speed (``speed`` m/s range)
  and yaw rate (+-``yaw_rate`` rad/s); the ego moves along its heading.
  The CAN-bus vector is the published test loop's: [0:3] the global
  translation since the last sample, [3:7] the ego's rotation quaternion
  (w, x, y, z), [7:10] acceleration, [10:13] rotation rate, [13:16]
  velocity, [16] the heading in radians in [0, 2 pi), [17] the heading's
  change in degrees (of its [0, 360) value, as published); at a scene's
  first sample [0:3] and [17] are 0 and ``scene_start`` is set.

Made in bulk with torch on the host; a pool's first image sets do not
depend on its size.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from mfbench.sources import Feed
from mfbench.sources.camera_rig_batches import render

WIDTH, HEIGHT = 1600, 900          # the size the mix's intrinsics are given at


def lidar2img(cameras: List[Dict], mount: float, mount_down: float, height: int,
              width: int) -> np.ndarray:
    """(cameras, 4, 4) float32 (module docstring)."""
    sx, sy = width / WIDTH, height / HEIGHT
    out = []
    for c in cameras:
        a = math.radians(c["yaw"])
        d = np.array([-math.sin(a), math.cos(a), 0.0])
        rot = np.stack([np.array([math.cos(a), math.sin(a), 0.0]), np.array([0.0, 0.0, -1.0]), d])
        extrinsic = np.eye(4)
        extrinsic[:3, :3] = rot
        extrinsic[:3, 3] = -rot @ (d * mount + np.array([0.0, 0.0, -mount_down]))
        k = np.eye(4)
        k[0, 0], k[1, 1] = c["fx"] * sx, c["fy"] * sy
        k[0, 2], k[1, 2] = c["cx"] * sx, c["cy"] * sy
        out.append(k @ extrinsic)
    return np.stack(out).astype(np.float32)


def scene(seed: int, s: int, traffic: Dict) -> Dict[str, float]:
    rng = np.random.default_rng([int(seed) % 2 ** 64, 23, s])
    lo, hi = traffic["speed"]
    return {"x": float(rng.uniform(-1000, 1000)), "y": float(rng.uniform(-1000, 1000)),
            "heading": float(rng.uniform(-math.pi, math.pi)), "speed": float(rng.uniform(lo, hi)),
            "yaw_rate": float(rng.uniform(-traffic["yaw_rate"], traffic["yaw_rate"]))}


def pose(sc: Dict[str, float], k: int, dt: float):
    """(x, y, heading) of a scene's k-th sample: constant speed and yaw rate."""
    x, y, h = sc["x"], sc["y"], sc["heading"]
    for _ in range(k):
        x += sc["speed"] * dt * math.cos(h)
        y += sc["speed"] * dt * math.sin(h)
        h += sc["yaw_rate"] * dt
    return x, y, h


def can_bus(seed: int, i: int, traffic: Dict) -> np.ndarray:
    """The i-th sample's CAN-bus vector (18,) float32 (module docstring)."""
    n, dt = int(traffic["scene_samples"]), float(traffic["dt"])
    sc = scene(seed, i // n, traffic)
    k = i % n
    x, y, h = pose(sc, k, dt)
    deg = math.degrees(h) % 360.0
    bus = np.zeros(18, dtype=np.float64)
    bus[3:7] = [math.cos(h / 2), 0.0, 0.0, math.sin(h / 2)]
    bus[7:10] = [0.0, 0.0, 9.81]
    bus[10:13] = [0.0, 0.0, sc["yaw_rate"]]
    bus[13:16] = [sc["speed"], 0.0, 0.0]
    bus[16] = math.radians(deg)
    if k > 0:
        px, py, ph = pose(sc, k - 1, dt)
        bus[0:2] = [x - px, y - py]
        bus[17] = deg - math.degrees(ph) % 360.0
    return bus.astype(np.float32)


def make(traffic, shape, seed, prog, cfg, scratch) -> Feed:
    cameras = traffic["cameras"][:shape["batch"]]
    if len(cameras) < shape["batch"]:
        cameras = (cameras * shape["batch"])[:shape["batch"]]
    h, w = shape["height"], shape["width"]
    l2i = lidar2img(cameras, traffic["mount"], traffic["mount_down"], h, w)
    images = [render(np.random.default_rng([int(seed) % 2 ** 64, 17, p]), len(cameras), h, w)
              for p in range(int(traffic["pool"]))]
    n = int(traffic["scene_samples"])

    def sample(i: int) -> Dict[str, np.ndarray]:
        return {"image": images[i % len(images)], "lidar2img": l2i,
                "can_bus": can_bus(seed, i, traffic),
                "scene_start": np.array([i % n == 0])}

    pool = [sample(p) for p in range(len(images))]
    return Feed(next=sample, steps_per_epoch=n, pool=pool)
