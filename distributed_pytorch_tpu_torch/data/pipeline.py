"""Host-side input pipeline: sharded, batched iteration over a Dataset.

A numpy-only copy of the JAX package's data/pipeline.py: ``DataLoader``
yields the same (images, labels) batches in the same order, and
``prefetch`` runs an iterable on a background thread.  It stands in for
the reference's ``DataLoader(train_set, sampler=DistributedSampler(...),
batch_size=256, num_workers=2, pin_memory=True)`` (reference:
main_all_reduce.py:112-117):

- the dataset is small and memory-resident, so batches are numpy slices
  (gather by fancy indexing) rather than worker processes; augmentation runs
  on the device (augment.py), so there is no host-side per-image work;
- the last, smaller batch is kept (DataLoader default drop_last=False); the
  sampler itself pads the epoch so every rank sees the same number of
  samples.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from .cifar10 import Dataset
from .sampler import DistributedSampler


class DataLoader:
    """Deterministic sharded batch iterator.

    ``sampler=None`` + ``shuffle=True`` reproduces the single-process
    baseline's loader (reference main.py:85-90: shuffle with no sampler).
    """

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        *,
        sampler: DistributedSampler | None = None,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if sampler is not None and shuffle:
            # torch DataLoader raises the same way: the sampler owns ordering.
            raise ValueError("sampler option is mutually exclusive with shuffle")
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        if self.sampler is not None:
            return np.asarray(self.sampler.indices())
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            return rng.permutation(len(self.dataset))
        return np.arange(len(self.dataset))

    def __len__(self) -> int:
        n = (self.sampler.num_samples if self.sampler is not None
             else len(self.dataset))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        idx = self._indices()
        end = (len(idx) // self.batch_size * self.batch_size
               if self.drop_last else len(idx))
        for start in range(0, end, self.batch_size):
            batch = idx[start : start + self.batch_size]
            yield self.dataset.images[batch], self.dataset.labels[batch]


def prefetch(iterable, depth: int = 2):
    """Run ``iterable`` in a background thread with a bounded queue.

    The host-side analog of the reference's DataLoader worker processes
    (reference main.py:85-90, num_workers=2): while the device executes the
    current step, the next batch is assembled (and, in Trainer.train_epoch,
    copied to the device).  Exceptions in the producer re-raise at the
    consumer.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up when the consumer is gone (an abandoned
        generator must not leave the producer blocked holding staged device
        buffers forever)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not _put(item):
                    return
            _put(done)
        except BaseException as e:  # surfaced at the consuming side
            _put(("__prefetch_error__", e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if (isinstance(item, tuple) and len(item) == 2
                    and item[0] == "__prefetch_error__"):
                raise item[1]
            yield item
    finally:
        stop.set()
        while True:  # release any buffered references
            try:
                q.get_nowait()
            except queue.Empty:
                break
