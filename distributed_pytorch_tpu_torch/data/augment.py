"""Device-side data augmentation: the port of the JAX package's
data/augment.py.

The reference augments on the host inside DataLoader worker processes
(reference: main.py:71-78 — RandomCrop(32, padding=4), RandomHorizontalFlip,
ToTensor, per-channel Normalize).  Here raw uint8 batches cross to the device
once and the crop / flip / normalize run there, batched: one draw of the
per-sample offsets and flips, one gather for all crops.

The work is split in two so that the arithmetic can be held against the JAX
package's: ``draw`` takes the per-sample offsets (0..2*PAD per axis) and
flips from a ``torch.Generator`` (not JAX's bits), and
``crop_flip_normalize`` is a pure function of the images and those draws,
equal bit for bit to the JAX ``augment`` given the offsets and flips JAX
drew.  Input is uint8 NHWC; output is float32 NCHW in ``channels_last``
memory format (a permute of the NHWC result, no copy), the layout of the
port's convolutions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cifar10 import MEAN, STD

PAD = 4  # reference main.py:72 RandomCrop(32, padding=4)


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> normalized float32 NCHW, channels_last (ToTensor +
    Normalize, main.py:73-77)."""
    x = images.float() / 255.0
    mean = torch.as_tensor(MEAN, device=x.device)
    std = torch.as_tensor(STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def draw(gen: torch.Generator, batch: int,
         device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample crop offsets (B, 2) in [0, 2*PAD] (row, column) and
    horizontal flips (B,) bool, from ``gen`` (on ``device``)."""
    off = torch.randint(0, 2 * PAD + 1, (batch, 2), generator=gen,
                        device=device)
    flip = torch.randint(0, 2, (batch,), generator=gen, device=device) == 1
    return off, flip


def crop_flip_normalize(images: torch.Tensor, off: torch.Tensor,
                        flip: torch.Tensor) -> torch.Tensor:
    """A 32x32 crop at ``off`` from the zero-padded canvas, mirrored where
    ``flip``, then normalized: the JAX ``augment`` after its draws."""
    b, h, w, _ = images.shape
    dev = images.device
    padded = F.pad(images, (0, 0, PAD, PAD, PAD, PAD))
    off = off.to(dev).long()
    rows = off[:, 0, None] + torch.arange(h, device=dev)          # (B, H)
    base = torch.arange(w, device=dev)
    # flip folded into the column indices: one gather, no second select
    cols = off[:, 1, None] + torch.where(flip.to(dev)[:, None],
                                         w - 1 - base, base)      # (B, W)
    x = padded[torch.arange(b, device=dev)[:, None, None],
               rows[:, :, None], cols[:, None, :]]
    return normalize(x)


def augment(gen: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Train-time augmentation: uint8 NHWC batch -> normalized float32 NCHW
    (channels_last), the reference's train transform stack
    (main.py:71-78)."""
    off, flip = draw(gen, images.shape[0], images.device)
    return crop_flip_normalize(images, off, flip)
