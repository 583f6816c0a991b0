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

``ElasticSampler`` is the JAX package's resize-stable sampler, also in
numpy: its indices are bitwise the JAX package's.
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


class ElasticSampler:
    """Resize-stable sampler for the elastic gang.

    ``DistributedSampler`` keys the whole epoch split on a fixed
    ``num_replicas``: resize mid-epoch and every rank's stride changes, so
    examples drop or count twice.  This sampler splits per step instead:
    the global consumption order is a function of ``(seed, epoch, step)``
    alone, never of the world size.  Each optimizer step's global batch is
    the next ``global_batch`` indices of the epoch permutation (padded by
    repeating the permutation's head, torch's ``drop_last=False``), and
    rank ``r`` of ``W`` takes the ``r``-th contiguous stripe, so the ranks'
    stripes concatenate into one canonical batch at any world size.

    ``set_generation`` re-keys the stripes after a re-rendezvous; from
    that step on they partition the same global order, so across a resize
    no example is dropped or counted twice.  A world size that does not
    divide ``global_batch`` is refused: an uneven stripe would change the
    per-rank batch.
    """

    def __init__(self, dataset_size: int, global_batch: int, *,
                 seed: int = 0, shuffle: bool = True):
        if dataset_size <= 0 or global_batch <= 0:
            raise ValueError(
                f"dataset_size/global_batch must be positive, got "
                f"{dataset_size}/{global_batch}")
        self.dataset_size = dataset_size
        self.global_batch = global_batch
        self.seed = seed
        self.shuffle = shuffle
        self.steps_per_epoch = math.ceil(dataset_size / global_batch)
        self.generation = 0
        self.world_size = 1
        self.rank = 0
        self._order: tuple[int, np.ndarray] | None = None  # epoch memo

    def set_generation(self, generation: int, world_size: int,
                       rank: int) -> None:
        """Re-key the stripes for a new membership (the elastic analog of
        ``set_epoch``), after every re-rendezvous."""
        if not 0 <= rank < world_size:
            raise ValueError(
                f"rank {rank} out of range for world size {world_size}")
        if self.global_batch % world_size:
            raise ValueError(
                f"cannot resize to world size {world_size}: global batch "
                f"{self.global_batch} does not divide evenly — the gang "
                f"must shrink/grow to a divisor of the batch")
        self.generation = generation
        self.world_size = world_size
        self.rank = rank

    def epoch_of(self, step: int) -> int:
        return step // self.steps_per_epoch

    def _epoch_order(self, epoch: int) -> np.ndarray:
        # the shuffle and pad once an epoch, not once a step
        if self._order is not None and self._order[0] == epoch:
            return self._order[1]
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            order = rng.permutation(self.dataset_size)
        else:
            order = np.arange(self.dataset_size)
        pad = self.steps_per_epoch * self.global_batch - self.dataset_size
        if pad > 0:
            order = np.concatenate([order, order[:pad]])
        self._order = (epoch, order)
        return order

    def global_indices(self, step: int) -> np.ndarray:
        """The global batch of optimizer step ``step``, the same at every
        world size."""
        epoch = self.epoch_of(step)
        offset = (step - epoch * self.steps_per_epoch) * self.global_batch
        return self._epoch_order(epoch)[offset:offset + self.global_batch]

    def indices(self, step: int) -> np.ndarray:
        """This rank's contiguous stripe of ``global_indices(step)``."""
        per = self.global_batch // self.world_size
        g = self.global_indices(step)
        return g[self.rank * per:(self.rank + 1) * per]
