"""Distributed sampler: deterministic per-rank index assignment.

A numpy-only copy of ``DistributedSampler`` from the JAX package's
data/sampler.py: for every (num_replicas, rank, epoch) it yields the same
indices.  It keeps the semantics of ``torch.utils.data.DistributedSampler``
as the reference uses it (reference: main_all_reduce.py:112):

- one *global* permutation drawn from ``seed + epoch``, shared by all ranks;
- ``drop_last=False``: the index list is padded by repeating its head so each
  rank receives exactly ``ceil(N / num_replicas)`` samples;
- rank assignment is strided: rank r takes ``indices[r::num_replicas]``.

The permutation comes from numpy's ``default_rng``, not torch's ``randperm``,
so the order equals the JAX package's, not the reference's.
``ElasticSampler`` comes with slice 5c (ROADMAP.md queue 1: durability
and observability).
"""

from __future__ import annotations

import math

import numpy as np


class DistributedSampler:
    """Yields the index shard for one rank, reshuffled per epoch.

    ``set_epoch`` mirrors the torch API: the permutation seed is
    ``seed + epoch`` so every epoch has a distinct but deterministic global
    shuffle shared by all ranks.
    """

    def __init__(
        self,
        dataset_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_size % num_replicas != 0:
            self.num_samples = dataset_size // num_replicas
        else:
            self.num_samples = math.ceil(dataset_size / num_replicas)
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        """The full index shard for this rank at the current epoch."""
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(self.dataset_size)
        else:
            order = np.arange(self.dataset_size)
        if not self.drop_last:
            pad = self.total_size - len(order)
            if pad > 0:
                # torch repeats the head of the (shuffled) list to pad.
                order = np.concatenate([order, order[:pad]])
        else:
            order = order[: self.total_size]
        return order[self.rank :: self.num_replicas]

    def __iter__(self):
        return iter(self.indices())

    def __len__(self) -> int:
        return self.num_samples
