"""The head-loss seam of the LM trainer: the port of the JAX package's
ops/losses.py ``head_loss`` with ``loss_impl="dense"``.  The streamed
(chunked) vocabulary cross-entropy is refused until a later slice
(ROADMAP.md queue 1)."""

from __future__ import annotations

import torch

from .nn import masked_ce

CHUNKED_CE_SLICE = ("ROADMAP.md queue 1, slice 6 (LM training at scale: "
                    "chunked CE)")


def head_loss(h: torch.Tensor, emb: torch.Tensor, targets: torch.Tensor, *,
              loss_impl: str = "dense", loss_chunk: int | None = None,
              tp_axis=None, tp_size: int = 1):
    """Final-norm hidden states + tied embedding -> ``(sum of masked CE,
    #unmasked tokens)``: float32 ``h @ emb.T`` then ``masked_ce``."""
    if loss_impl == "chunked":
        raise NotImplementedError(
            "loss_impl='chunked' (streamed vocabulary cross-entropy) is not "
            f"ported to PyTorch yet: {CHUNKED_CE_SLICE}")
    if loss_impl != "dense":
        raise ValueError(f"unknown loss_impl {loss_impl!r}: expected 'dense' "
                         "or 'chunked'")
    if loss_chunk is not None or tp_axis is not None or tp_size != 1:
        raise NotImplementedError(
            "loss_chunk / tp_axis / tp_size belong to the chunked or "
            f"tensor-parallel head, not ported to PyTorch yet: "
            f"{CHUNKED_CE_SLICE}")
    logits = h.float() @ emb.float().T
    return masked_ce(logits, targets)
