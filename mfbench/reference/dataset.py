"""KITTI dataset: image / calib / label loading + per-image target encoding.

Re-design of the reference dataset (reference: data/datasets/kitti.py:28-525)
returning plain fixed-shape numpy dicts instead of framework containers, so
batches stack into fixed-shape tensors.  A copy of the JAX package's
``data/dataset.py``.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from .geometry_np import Calibration
from .augmentations import RandomHorizontalFlip, build_augmentations
from .kitti_objects import Object3d, read_label
from .target_encoder import EncoderSpec, encode_targets, pad_image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


class KITTIDataset:
    def __init__(self, cfg, root: str, is_train: bool = True, augment: bool = True,
                 seed: Optional[int] = None):
        self.root = root
        self.image_dir = os.path.join(root, "image_2")
        self.image_right_dir = os.path.join(root, "image_3")
        self.label_dir = os.path.join(root, "label_2")
        self.calib_dir = os.path.join(root, "calib")

        self.split = cfg.DATASETS.TRAIN_SPLIT if is_train else cfg.DATASETS.TEST_SPLIT
        self.is_train = is_train
        imageset_txt = os.path.join(root, "ImageSets", f"{self.split}.txt")
        if not os.path.exists(imageset_txt):
            raise FileNotFoundError(f"ImageSets file not found: {imageset_txt}")
        with open(imageset_txt) as f:
            base_names = [line.strip() for line in f if line.strip()]
        self.image_files = [b + ".png" for b in base_names]
        self.label_files = [b + ".txt" for b in base_names]

        self.classes = tuple(cfg.DATASETS.DETECT_CLASSES)
        self.num_samples = len(self.image_files)
        self.use_right_img = bool(cfg.DATASETS.USE_RIGHT_IMAGE) and is_train

        # the test split sizes to INPUT.*_TEST (reference: data/datasets/
        # kitti.py reads the split-specific input size); using the train
        # resolution here silently mis-sizes --eval at a different test res
        self.spec = EncoderSpec.from_cfg(cfg, is_train=is_train)
        self.pixel_mean = np.asarray(cfg.INPUT.PIXEL_MEAN, dtype=np.float32)
        self.pixel_std = np.asarray(cfg.INPUT.PIXEL_STD, dtype=np.float32)
        self.to_bgr = bool(cfg.INPUT.TO_BGR)
        self.device_normalize = bool(cfg.INPUT.DEVICE_NORMALIZE)

        self.rng = random.Random(seed)
        self.augmentations = build_augmentations(cfg.INPUT.AUG_PARAMS) if (is_train and augment) else []
        for aug in self.augmentations:
            aug.rng = self.rng

    def __len__(self) -> int:
        return self.num_samples * 2 if self.use_right_img else self.num_samples

    # -- raw accessors -----------------------------------------------------
    def get_image(self, idx: int, right: bool = False) -> Image.Image:
        d = self.image_right_dir if right else self.image_dir
        return Image.open(os.path.join(d, self.image_files[idx])).convert("RGB")

    def get_calibration(self, idx: int, use_right_cam: bool = False) -> Calibration:
        return Calibration.from_kitti_file(
            os.path.join(self.calib_dir, self.label_files[idx]), use_right_cam=use_right_cam)

    def get_label_objects(self, idx: int) -> List[Object3d]:
        return read_label(os.path.join(self.label_dir, self.label_files[idx]))

    def filtrate_objects(self, objs: List[Object3d]) -> List[Object3d]:
        return [o for o in objs if o.type in self.classes]

    # -- sample construction ----------------------------------------------
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        use_right = idx >= self.num_samples
        if use_right:
            idx = idx % self.num_samples
            img = self.get_image(idx, right=True)
            calib = self.get_calibration(idx, use_right_cam=True)
            objs = None if self.split == "test" else self.get_label_objects(idx)
            if objs is not None:
                # re-derive 2D boxes by projecting 3D corners with the right cam
                img_w, img_h = img.size
                for obj in objs:
                    corners_2d, _ = calib.project_rect_to_image(obj.generate_corners3d())
                    obj.box2d = np.array([
                        max(corners_2d[:, 0].min(), 0), max(corners_2d[:, 1].min(), 0),
                        min(corners_2d[:, 0].max(), img_w - 1),
                        min(corners_2d[:, 1].max(), img_h - 1),
                    ], dtype=np.float32)
                    obj.xmin, obj.ymin, obj.xmax, obj.ymax = obj.box2d
        else:
            img = self.get_image(idx)
            calib = self.get_calibration(idx)
            objs = None if self.split == "test" else self.get_label_objects(idx)

        original_idx = self.image_files[idx][:6]
        if objs is not None:
            objs = self.filtrate_objects(objs)

        for aug in self.augmentations:
            img, objs, calib = aug(img, objs, calib)

        img_w, img_h = img.size
        img_np = np.asarray(img, dtype=np.float32)
        padded, pad_size = pad_image(img_np, self.spec)

        sample = encode_targets(
            objs if self.split != "test" else None, calib, (img_w, img_h), pad_size, self.spec)
        if self.device_normalize:
            # ship raw uint8: 4x smaller host->device transfer, ~10 ms/img
            # less host work; the model normalizes on-device (detector.py)
            sample["image"] = padded.astype(np.uint8)
        else:
            sample["image"] = self.normalize(padded)
        sample["image_id"] = np.array(int(original_idx), dtype=np.int32)
        return sample

    def normalize(self, img_hwc: np.ndarray) -> np.ndarray:
        x = img_hwc / 255.0
        if self.to_bgr:
            x = x[..., ::-1]
        return ((x - self.pixel_mean) / self.pixel_std).astype(np.float32)


class CachedFlipDataset:
    """In-memory memoization of encoded training samples for small datasets.

    The pipeline's only train-time randomness is the p=0.5 horizontal flip
    (reference: data/augmentations/augmentations.py:28-77), so each index has
    exactly two possible encodings.  Cache both lazily and draw the coin here:
    steady-state epochs then cost zero host encode work, which matters on
    few-core hosts driving many epochs over small (synthetic) sets where the
    ~27 ms/img encode otherwise starves the accelerator.  Enable with
    ``DATALOADER.CACHE_DATASET True``.
    """

    def __init__(self, cfg, root: str, is_train: bool = True,
                 seed: Optional[int] = None):
        self.plain = KITTIDataset(cfg, root, is_train=is_train, augment=False,
                                  seed=seed)
        self.flipped = KITTIDataset(cfg, root, is_train=is_train,
                                    augment=False, seed=seed)
        self.flipped.augmentations = [RandomHorizontalFlip(1.0)]
        aug = cfg.INPUT.AUG_PARAMS
        self.flip_p = float(aug[0][0]) if (
            is_train and aug and len(aug[0]) > 0) else 0.0
        self.rng = random.Random(seed)
        self._cache: Dict = {}

    def __len__(self) -> int:
        return len(self.plain)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        flip = self.rng.random() < self.flip_p
        key = (idx, flip)
        sample = self._cache.get(key)
        if sample is None:
            sample = (self.flipped if flip else self.plain)[idx]
            self._cache[key] = sample
        return sample
