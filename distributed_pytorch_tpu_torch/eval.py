"""Evaluation with the reference's ``test_model`` semantics: the port of
``evaluate`` of the JAX package's eval.py.

Reference (main.py:51-66): model.eval(), no grad, sum the per-batch mean
losses, divide by the *number of batches*, and argmax accuracy over the full
test set, with BN running statistics.  Batches are padded to the first
batch's size with a validity mask (``_pad_batch``), as in the JAX package,
so the ragged last batch counts only its real samples.
``evaluate_sharded`` splits the test set over the ranks of a mesh and
all-reduces the sums, with the same loss definition.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .data import augment as aug
from .models import vgg
from .ops import nn as ops
from .parallel.mesh import mesh_group
from .utils.device import resolve_device


def _batch_metrics(params, state, images, labels, mask, *, model_name,
                   dtype, folded=False):
    """Masked (ce_sum, correct, n_real) for one padded batch.  With
    ``folded``, ``params`` is a ``vgg.fold_bn`` dict (state unused)."""
    x = aug.normalize(images)  # test transform: ToTensor+Normalize
    if folded:
        logits = vgg.apply_folded(params, x, name=model_name, dtype=dtype)
    else:
        logits, _ = vgg.apply(params, state, x, name=model_name,
                              train=False, dtype=dtype)
    ce = ops.cross_entropy_per_sample(logits, labels) * mask
    correct = ((logits.argmax(-1) == labels) * mask).sum()
    return ce.sum(), correct, mask.sum()


def _pad_batch(images, labels, batch_size):
    """Pad a ragged batch to ``batch_size`` + validity mask."""
    n = len(labels)
    if n < batch_size:
        pad = batch_size - n
        images = np.concatenate(
            [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
        labels = np.concatenate([labels, np.zeros(pad, labels.dtype)])
    mask = (np.arange(batch_size) < n).astype(np.float32)
    return images, labels, mask, n


@torch.no_grad()
def evaluate(params: dict, state: dict, loader, *,
             model_name: str = "VGG11",
             compute_dtype: torch.dtype | None = None,
             fold_bn: bool = False, log=print,
             device: str | torch.device = "cuda") -> tuple[float, float]:
    """Full-test-set eval on ``device``; returns (avg_loss, accuracy).

    ``avg_loss`` is the sum of per-batch mean losses divided by the batch
    count, the reference's definition (main.py:59,63).  ``fold_bn`` folds
    the BN statistics into the conv weights once up front
    (``vgg.fold_bn``).  ``device`` defaults to ``"cuda"`` and raises
    without a GPU unless ``"cpu"`` is asked for."""
    dev = resolve_device(device)
    params, state = vgg.to_device(params, dev), vgg.to_device(state, dev)
    if fold_bn:
        params = vgg.fold_bn(params, state, name=model_name)
    total_loss, correct, total, n_batches = 0.0, 0, 0, 0
    batch_size = None
    for images, labels in loader:
        if batch_size is None:
            batch_size = len(labels)
        images, labels, mask, n = _pad_batch(images, labels, batch_size)
        ce_sum, corr, n_real = _batch_metrics(
            params, state, torch.as_tensor(images).to(dev),
            torch.as_tensor(labels).to(dev).long(),
            torch.as_tensor(mask).to(dev), model_name=model_name,
            dtype=compute_dtype, folded=fold_bn)
        # per-batch mean over real samples == CrossEntropyLoss reduction
        total_loss += float(ce_sum / n_real.clamp_min(1))
        correct += int(corr)
        total += n
        n_batches += 1
    avg_loss = total_loss / max(n_batches, 1)
    acc = correct / max(total, 1)
    if log:
        log(f"Test set: Average loss: {avg_loss:.4f}, "
            f"Accuracy: {correct}/{total} ({100.0 * acc:.0f}%)\n")
    return avg_loss, acc


@torch.no_grad()
def evaluate_sharded(params: dict, state: dict, dataset, mesh, *,
                     batch_size: int = 256, model_name: str = "VGG11",
                     compute_dtype: torch.dtype | None = None,
                     fold_bn: bool = False, log=print,
                     device: str | torch.device = "cuda"
                     ) -> tuple[float, float]:
    """Evaluation split over the ranks of ``mesh`` (a ``DeviceMesh`` or a
    process group): rank r takes rows ``[r b/n, (r+1) b/n)`` of every
    padded batch and the per-batch sums are all-reduced (one collective a
    batch), where ``evaluate`` has every rank evaluate all of the test set
    (main_gather.py:131).  The loss definition is ``evaluate``'s (the sum
    of per-batch means over real samples, over the batch count), which is
    why ``batch_size`` must divide by the ranks, as in the JAX package.
    ``state`` is rank 0's BN state (``Trainer.eval_state``).  Every rank
    must call it."""
    group = mesh_group(mesh) if isinstance(mesh, DeviceMesh) else mesh
    n_dev = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if batch_size % max(n_dev, 1):
        raise ValueError(f"batch_size {batch_size} must be divisible by the "
                         f"{n_dev}-device mesh for loss parity with "
                         f"evaluate()")
    dev = resolve_device(device)
    params, state = vgg.to_device(params, dev), vgg.to_device(state, dev)
    if fold_bn:
        params = vgg.fold_bn(params, state, name=model_name)
    per = batch_size // n_dev
    rows = slice(rank * per, (rank + 1) * per)
    total_loss, correct, total, n_batches = 0.0, 0, 0, 0
    images_all, labels_all = dataset.images, dataset.labels
    for start in range(0, len(labels_all), batch_size):
        images, labels, mask, n = _pad_batch(
            images_all[start:start + batch_size],
            labels_all[start:start + batch_size], batch_size)
        ce_sum, corr, n_real = _batch_metrics(
            params, state, torch.as_tensor(images[rows]).to(dev),
            torch.as_tensor(labels[rows]).to(dev).long(),
            torch.as_tensor(mask[rows]).to(dev), model_name=model_name,
            dtype=compute_dtype, folded=fold_bn)
        sums = torch.stack([ce_sum.double(), corr.double(),
                            n_real.double()])
        dist.all_reduce(sums, group=group)
        ce_sum, corr, n_real = sums.tolist()
        total_loss += ce_sum / max(n_real, 1.0)
        correct += int(corr)
        total += n
        n_batches += 1
    avg_loss = total_loss / max(n_batches, 1)
    acc = correct / max(total, 1)
    if log:
        log(f"Test set (sharded x{n_dev}): Average loss: {avg_loss:.4f}, "
            f"Accuracy: {correct}/{total} ({100.0 * acc:.0f}%)\n")
    return avg_loss, acc
