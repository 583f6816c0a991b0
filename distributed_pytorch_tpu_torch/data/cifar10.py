"""CIFAR-10 dataset: on-disk loading with a deterministic synthetic fallback.

A numpy-only copy of the JAX package's data/cifar10.py (the port imports
nothing of that package).  With no dataset on disk, ``load`` returns the same
synthetic split, bit for bit, from the same ``default_rng`` seeds.

It reads the python pickle batches (``data_batch_1..5`` / ``test_batch``
inside ``cifar-10-batches-py``, or ``cifar-10-python.tar.gz``) from
``data_dir``, or else from ``./data`` or ``data/`` at the repository root,
and falls back to class-separable synthetic data with the same
shapes and dtypes when none is found.

Images are uint8 NHWC (N, 32, 32, 3); augmentation and normalisation run on
the device (augment.py) with the reference's per-channel constants
(reference: main.py:74-77).
"""

from __future__ import annotations

import os
import pickle
import tarfile
from dataclasses import dataclass

import numpy as np

# Reference main.py:71-72 — mean/std in [0,1] units, exact constants.
MEAN = np.array([125.3, 123.0, 113.9], np.float32) / 255.0
STD = np.array([63.0, 62.1, 66.7], np.float32) / 255.0

TRAIN_SIZE = 50_000
TEST_SIZE = 10_000

# Only places inside the working tree: the current directory's data/ and the
# repository's own data/ (the port reads nothing else around its checkout).
_SEARCH_DIRS = (
    "./data", os.path.join(os.path.dirname(__file__), "..", "..", "data"),
)


@dataclass
class Dataset:
    """In-memory image-classification split."""

    images: np.ndarray  # uint8 (N, 32, 32, 3)
    labels: np.ndarray  # int32 (N,)
    synthetic: bool = False

    def __len__(self) -> int:
        return len(self.images)


def _find_batches_dir(data_dir: str | None) -> str | None:
    dirs = [data_dir] if data_dir else list(_SEARCH_DIRS)
    for d in dirs:
        if d is None:
            continue
        d = os.path.expanduser(d)
        for cand in (os.path.join(d, "cifar-10-batches-py"), d):
            if os.path.isfile(os.path.join(cand, "data_batch_1")):
                return cand
        tgz = os.path.join(d, "cifar-10-python.tar.gz")
        if os.path.isfile(tgz):
            with tarfile.open(tgz) as tf:
                tf.extractall(d, filter="data")
            cand = os.path.join(d, "cifar-10-batches-py")
            if os.path.isfile(os.path.join(cand, "data_batch_1")):
                return cand
    return None


def _load_batch(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    # stored as (N, 3072) uint8, channel-major -> NHWC
    images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(d[b"labels"], np.int32)
    return np.ascontiguousarray(images), labels


def _synthetic(n: int, seed: int) -> Dataset:
    """Deterministic class-separable synthetic data (CIFAR shapes/dtypes).

    Each class gets a fixed random 'template' image; samples are the template
    plus noise, so a real model can actually learn (used by loss-decreases
    and loss-parity tests when the real dataset is unavailable).

    The templates ARE the class definition, so they come from a fixed seed
    shared by every split; only the sample noise/labels vary with ``seed``
    (otherwise train and test would be different classification problems
    and test accuracy could never beat chance)."""
    templates = np.random.default_rng(0).integers(
        0, 256, (10, 32, 32, 3)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    noise = rng.normal(0, 64, (n, 32, 32, 3)).astype(np.float32)
    images = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
    return Dataset(images=images, labels=labels, synthetic=True)


def load(split: str = "train", data_dir: str | None = None) -> Dataset:
    """Load a CIFAR-10 split, synthetic fallback if no data on disk."""
    assert split in ("train", "test")
    batches_dir = _find_batches_dir(data_dir)
    if batches_dir is None:
        n = TRAIN_SIZE if split == "train" else TEST_SIZE
        return _synthetic(n, seed=0 if split == "train" else 1)
    if split == "train":
        parts = [_load_batch(os.path.join(batches_dir, f"data_batch_{i}"))
                 for i in range(1, 6)]
        images = np.concatenate([p[0] for p in parts])
        labels = np.concatenate([p[1] for p in parts])
    else:
        images, labels = _load_batch(os.path.join(batches_dir, "test_batch"))
    return Dataset(images=images, labels=labels)
