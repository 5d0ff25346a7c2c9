"""Batch pipeline: samplers, collation, threaded prefetch.

A copy of the JAX package's loader (reference: data/build.py:58-166,
data/samplers/distributed_sampler.py:12-54, data/collate_batch.py:5):
fixed-shape dict batches, rank-strided infinite sampling for data
parallelism, and a background thread pool that keeps the card fed (encode is
numpy-bound, threads release the GIL in PIL/numpy).  Batches stay numpy: the
worker threads never touch CUDA, and the engine moves each batch to the
device in the calling thread.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of fixed-shape sample dicts into one batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


class TrainingSampler:
    """Infinite shuffled index stream, rank-strided across processes
    (reference: data/samplers/distributed_sampler.py:12-54)."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            rng = np.random.RandomState(self.seed + epoch)
            order = rng.permutation(self.size) if self.shuffle else np.arange(self.size)
            yield from order[self.rank::self.world_size].tolist()
            epoch += 1


class RepeatFactorTrainingSampler:
    """LVIS-style category-rebalancing sampler: images with rare categories
    are repeated with factor max_c sqrt(t / f_c)
    (reference: data/samplers/distributed_sampler.py:60-172; unused by the
    shipped config but part of the sampler API)."""

    def __init__(self, repeat_factors, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        rf = np.asarray(repeat_factors, dtype=np.float64)
        self._int_part = np.floor(rf).astype(np.int64)
        self._frac_part = rf - self._int_part

    @staticmethod
    def repeat_factors_from_category_frequency(dataset_category_ids, repeat_thresh: float):
        """dataset_category_ids: list of per-image category-id lists."""
        from collections import Counter

        counter: Counter = Counter()
        for cats in dataset_category_ids:
            counter.update(set(cats))
        num_images = len(dataset_category_ids)
        cat_freq = {c: n / num_images for c, n in counter.items()}
        cat_rep = {c: max(1.0, np.sqrt(repeat_thresh / f)) for c, f in cat_freq.items()}
        return np.array([
            max([cat_rep[c] for c in set(cats)], default=1.0)
            for cats in dataset_category_ids
        ])

    def _indices_for_epoch(self, rng: np.random.RandomState) -> np.ndarray:
        rands = rng.rand(len(self._frac_part))
        repeats = self._int_part + (rands < self._frac_part).astype(np.int64)
        return np.repeat(np.arange(len(repeats)), repeats)

    def __iter__(self):
        epoch = 0
        while True:
            rng = np.random.RandomState(self.seed + epoch)
            indices = self._indices_for_epoch(rng)
            if self.shuffle:
                indices = indices[rng.permutation(len(indices))]
            yield from indices[self.rank::self.world_size].tolist()
            epoch += 1


class GroupedBatchSampler:
    """Batch indices so that each batch contains only samples from one group
    (e.g. aspect-ratio groups; reference: data/samplers/grouped_batch_sampler.py:9)."""

    def __init__(self, sampler, group_ids, batch_size: int, drop_uneven: bool = False):
        self.sampler = sampler
        self.group_ids = np.asarray(group_ids)
        self.batch_size = batch_size
        self.drop_uneven = drop_uneven

    def __iter__(self):
        buffers: Dict[int, list] = {}
        for idx in self.sampler:
            gid = int(self.group_ids[idx])
            buffers.setdefault(gid, []).append(idx)
            if len(buffers[gid]) == self.batch_size:
                yield buffers.pop(gid)
        if not self.drop_uneven:
            for batch in buffers.values():
                if batch:
                    yield batch


class InferenceSampler:
    """Contiguous per-rank shards covering the dataset exactly once
    (reference: data/samplers/distributed_sampler.py:175-202)."""

    def __init__(self, size: int, rank: int = 0, world_size: int = 1):
        shard_sizes = [size // world_size + int(r < size % world_size)
                       for r in range(world_size)]
        begin = sum(shard_sizes[:rank])
        self.indices = list(range(begin, begin + shard_sizes[rank]))

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices)

    def __len__(self) -> int:
        return len(self.indices)


class DataLoader:
    """Threaded map-style loader with prefetch.

    ``batch_size`` here is the per-process batch.
    """

    def __init__(self, dataset, sampler, batch_size: int, num_workers: int = 8,
                 prefetch: int = 2, drop_last: bool = True, infinite: bool = False,
                 pad_last: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.infinite = infinite
        # pad the final short batch by repeating its last sample (marked with
        # image_id = -1) so the model never sees a remainder batch
        self.pad_last = pad_last

    def _batch_indices(self) -> Iterator[List[int]]:
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                try:
                    for batch_idx in self._batch_indices():
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, batch_idx))
                        if self.pad_last and len(samples) < self.batch_size:
                            filler = dict(samples[-1])
                            filler["image_id"] = np.array(-1, dtype=np.int32)
                            if "reg_mask" in filler:
                                filler["reg_mask"] = np.zeros_like(filler["reg_mask"])
                            samples += [filler] * (self.batch_size - len(samples))
                        out_q.put(collate(samples))
                    out_q.put(None)
                except Exception as e:  # surface worker errors to the consumer
                    out_q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def make_train_loader(cfg, dataset, rank: int = 0, world_size: int = 1,
                      seed: int = 0) -> DataLoader:
    """Global batch divided by world size, as in the reference
    (reference: data/build.py:61-74)."""
    global_batch = cfg.SOLVER.IMS_PER_BATCH
    if global_batch % world_size != 0:
        raise ValueError(f"IMS_PER_BATCH={global_batch} not divisible by world size {world_size}")
    sampler = TrainingSampler(len(dataset), shuffle=True, seed=seed,
                              rank=rank, world_size=world_size)
    return DataLoader(dataset, sampler, global_batch // world_size,
                      num_workers=cfg.DATALOADER.NUM_WORKERS,
                      prefetch=cfg.DATALOADER.PREFETCH_BATCHES,
                      drop_last=True, infinite=True)


def make_test_loader(cfg, dataset, rank: int = 0, world_size: int = 1,
                     batch_size: Optional[int] = None) -> DataLoader:
    sampler = InferenceSampler(len(dataset), rank=rank, world_size=world_size)
    return DataLoader(dataset, sampler, batch_size or cfg.TEST.IMS_PER_BATCH,
                      num_workers=cfg.DATALOADER.NUM_WORKERS,
                      prefetch=cfg.DATALOADER.PREFETCH_BATCHES,
                      drop_last=False, infinite=False, pad_last=True)
