"""Deterministic sharded index streams — the port's own copy of
mds_tpu/data/sampler.py (`RepeatedDistSampler` :19, `InfiniteStream` :64):
for the same arguments they give the same indices.

`RepeatedDistSampler` concatenates permutations of the dataset seeded by
the repeat index, truncates to ceil(num_imgs / world) · world and strides
by rank; `ba` repeats each index max(4, world) times. `InfiniteStream`
re-derives an epoch's permutation (seed + epoch) whenever the last one runs
out, forever.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Iterator, List

import numpy as np


class RepeatedDistSampler:
    def __init__(self, dataset_len: int, num_imgs: int, num_replicas: int = 1,
                 rank: int = 0, shuffle: bool = True, ba: bool = False):
        if dataset_len <= 0 or num_imgs <= 0:
            raise ValueError(f"need dataset_len, num_imgs > 0, got {dataset_len}, {num_imgs}")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.num_imgs_rank = -(-num_imgs // num_replicas)  # ceil
        self.total_size = self.num_imgs_rank * num_replicas
        self.num_imgs = num_imgs
        self.shuffle = shuffle
        self.ba = ba

    def indices(self) -> np.ndarray:
        n_repeats = self.num_imgs // self.dataset_len + 1
        chunks: List[np.ndarray] = []
        for n in range(n_repeats):
            if self.shuffle:
                chunks.append(np.random.default_rng(n).permutation(self.dataset_len))
            else:
                chunks.append(np.arange(self.dataset_len))
        indices = np.concatenate(chunks)[: self.total_size]
        if self.ba:
            n_rep = max(4, self.num_replicas)
            indices = np.repeat(indices[: len(indices) // n_rep + 1], n_rep)
        return indices[self.rank: self.total_size: self.num_replicas]

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices().tolist())

    def __len__(self) -> int:
        return self.num_imgs_rank


class InfiniteStream:
    """Endless index stream. The loader's pool threads call `__next__` at
    once, so the check, refill and pop are one critical section: without
    the lock two threads at an epoch's end could both refill, or pop from an
    empty buffer."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._buf: deque = deque()
        self._lock = threading.Lock()

    def __next__(self) -> int:
        with self._lock:
            if not self._buf:
                if self.shuffle:
                    perm = np.random.default_rng(
                        self.seed + self._epoch).permutation(self.dataset_len)
                else:
                    perm = np.arange(self.dataset_len)
                self._buf = deque(perm[self.rank:: self.num_replicas].tolist())
                self._epoch += 1
            return self._buf.popleft()

    def __iter__(self):
        return self
