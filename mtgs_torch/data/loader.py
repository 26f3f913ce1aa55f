"""Host-side data loading: cache strategies and samplers; port of
`mtgs_tpu/data/loader.py`.

Replaces the reference's datamanager/dataloader stack
(`mtgs/dataset/custom_datamanager.py`, `mtgs/dataset/utils/dataloader.py`,
`mtgs/dataset/utils/sampler.py` in OpenDriveLab/MTGS):

  * cache strategies: `on_demand` (LRU), `prefetch` (a thread pool warms
    the whole epoch), `async` (background threads fill a dict cache, the
    main thread falls through to a synchronous load on a miss) — ref
    `dataloader.py:32-157`;
  * samplers: epoch shuffle without replacement, and the
    traversal-balanced sampler (uniform over traversals, then uniform
    over that traversal's images) — ref `sampler.py:9-58`;
  * uint8 host cache (images kept as uint8, converted on emit) — ref
    `custom_datamanager.py:56-60`.

Emits the port's `train.trainer.Batch` with its tensors on an explicit
device ("cuda" unless the caller passes another). The decoders release the
GIL, so the pool's threads decode in parallel.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from mtgs_torch import resolve_device
from mtgs_torch.data.dataset import SampleConfig, load_sample
from mtgs_torch.data.nuplan import ImageRecord, ParsedScene
from mtgs_torch.train.trainer import Batch


class CameraSampler:
    """Shuffle-without-replacement epoch sampler (ref sampler.py:9-25)."""

    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self.rng = np.random.default_rng(seed)
        self._order: List[int] = []

    def __next__(self) -> int:
        if not self._order:
            self._order = list(self.rng.permutation(self.n))
        return int(self._order.pop())


class TraversalBalancedSampler:
    """Uniform over traversals, then over that traversal's images
    (ref sampler.py:27-58)."""

    def __init__(self, travel_of_image: np.ndarray, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.groups: Dict[int, np.ndarray] = {
            t: np.where(travel_of_image == t)[0]
            for t in np.unique(travel_of_image)
        }
        self.travels = list(self.groups)

    def __next__(self) -> int:
        t = self.travels[self.rng.integers(len(self.travels))]
        g = self.groups[t]
        return int(g[self.rng.integers(len(g))])


class SampleCache:
    """uint8 host cache with on_demand / prefetch / async strategies."""

    def __init__(
        self,
        records: List[ImageRecord],
        cfg: SampleConfig,
        strategy: str = "prefetch",
        num_workers: int = 4,
        max_items: Optional[int] = None,
    ):
        self.records = records
        self.cfg = cfg
        self.strategy = strategy
        self._cache: Dict[int, dict] = {}
        self._lock = threading.Lock()
        self._lru: collections.OrderedDict = collections.OrderedDict()
        self.max_items = max_items
        self._pool = None
        if strategy in ("prefetch", "async"):
            self._pool = ThreadPoolExecutor(max_workers=num_workers)
            if strategy == "prefetch":
                for i in range(len(records)):
                    self._pool.submit(self._fill, i)

    def _load(self, i: int) -> dict:
        s = load_sample(self.records[i], self.cfg)
        # uint8-compress the image for the host cache
        s["image_u8"] = (np.clip(s.pop("image"), 0, 1) * 255).astype(np.uint8)
        return s

    def _fill(self, i: int):
        # a background load that fails leaves the slot empty: `get` then
        # loads the sample itself and raises the error to the caller
        try:
            s = self._load(i)
        except (OSError, ValueError):
            return
        with self._lock:
            self._cache[i] = s

    def prefetch(self, i: int):
        if self.strategy == "async" and i not in self._cache:
            self._pool.submit(self._fill, i)

    def close(self):
        """Release the worker pool and the cache (the stage-switch memory
        release, ref `custom_datamanager.py:248-258`)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
        with self._lock:
            self._cache.clear()
            self._lru.clear()

    def get(self, i: int) -> dict:
        with self._lock:
            s = self._cache.get(i)
        if s is None:
            s = self._load(i)
            if self.strategy != "on_demand" or self.max_items:
                with self._lock:
                    self._cache[i] = s
                    self._lru[i] = True
                    if self.max_items and len(self._lru) > self.max_items:
                        old, _ = self._lru.popitem(last=False)
                        self._cache.pop(old, None)
        return s


def batch_from_sample(rec: ImageRecord, s: dict, device="cuda") -> Batch:
    """One view's Batch, its arrays as float32 tensors on `device`."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    img = s["image_u8"].astype(np.float32) / 255.0
    h, w = img.shape[:2]
    zeros = np.zeros((h, w, 1), np.float32)
    return Batch(
        image=t(img),
        mask=t(s["mask"]),
        c2w=t(rec.c2w),
        K=t(s["K"]),
        cam_idx=int(rec.cam_idx),
        image_idx=int(rec.frame_idx * 16 + rec.cam_idx),
        travel_index=int(rec.travel_index),
        frame_idx=int(rec.frame_idx),
        timestamp=float(np.float32(rec.timestamp)),
        lidar_depth=t(s.get("lidar_depth", zeros)),
        pseudo_depth=t(s.get("pseudo_depth", zeros)),
    )


def data_iterator(
    scene: ParsedScene,
    cfg: SampleConfig,
    *,
    balanced: bool = False,
    strategy: str = "prefetch",
    num_workers: int = 4,
    seed: int = 0,
    lookahead: int = 8,
    cache: Optional[SampleCache] = None,
    device="cuda",
) -> Iterator[Batch]:
    """Infinite Batch iterator over a parsed scene's records."""
    dev = resolve_device(device)
    records = scene.records
    if cache is None:
        cache = SampleCache(records, cfg, strategy=strategy, num_workers=num_workers)
    if balanced:
        travel_of_image = np.array([r.travel_index for r in records])
        sampler: Iterator[int] = TraversalBalancedSampler(travel_of_image, seed)
    else:
        sampler = CameraSampler(len(records), seed)
    pending: collections.deque = collections.deque()
    while True:
        while len(pending) < lookahead:
            i = next(sampler)
            cache.prefetch(i)
            pending.append(i)
        i = pending.popleft()
        yield batch_from_sample(records[i], cache.get(i), device=dev)


def staged_iterator_factory(scene, cfg, **loader_kw):
    """`scale -> Iterator[Batch]` factory for the multi-resolution
    training ladder (ref `custom_datamanager.py:143-152,248-258` in
    OpenDriveLab/MTGS: one dataloader per `scaling_factors` stage, caches
    released on stage switch). Each call builds a fresh `data_iterator`
    whose sample scale is `base_scale * stage_scale` and closes the
    previous stage's cache (worker pool and host memory)."""
    strategy = loader_kw.pop("strategy", "prefetch")
    num_workers = loader_kw.pop("num_workers", 4)
    prev: List[SampleCache] = []

    def factory(stage_scale: float):
        if prev:
            prev.pop().close()
        stage_cfg = dataclasses.replace(cfg, scale_factor=cfg.scale_factor * stage_scale)
        cache = SampleCache(scene.records, stage_cfg, strategy=strategy,
                            num_workers=num_workers)
        prev.append(cache)
        return data_iterator(scene, stage_cfg, cache=cache, **loader_kw)

    return factory
