"""Evaluation with the reference's ``test_model`` semantics: the port of
``evaluate`` of the JAX package's eval.py.

Reference (main.py:51-66): model.eval(), no grad, sum the per-batch mean
losses, divide by the *number of batches*, and argmax accuracy over the full
test set, with BN running statistics.  Batches are padded to the first
batch's size with a validity mask (``_pad_batch``), as in the JAX package,
so the ragged last batch counts only its real samples.  The sharded
evaluation (``evaluate_sharded``) comes with the data-parallel slice
(ROADMAP.md queue 1, slice 5).
"""

from __future__ import annotations

import numpy as np
import torch

from .data import augment as aug
from .models import vgg
from .ops import nn as ops
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
