"""The head-loss seam of the LM trainer: the port of the JAX package's
ops/losses.py.

- ``head_loss``: final-norm hidden states + tied embedding -> ``(sum of
  masked CE, #unmasked tokens)``.  ``loss_impl="dense"`` is float32
  ``h @ emb.T`` then ``masked_ce``; ``"chunked"`` streams the vocabulary
  through ``masked_ce_chunked`` so the (B, T, V) float32 logits never
  exist.
- ``masked_ce_chunked``: a ``torch.autograd.Function`` that walks the
  vocabulary in chunks with an online logsumexp, saving only the hidden
  states, the embedding, the targets and the (B T,) logsumexp; the backward
  recomputes each chunk's logits and emits the hidden and embedding
  gradients chunk by chunk (softmax minus one-hot), the JAX
  ``_fwd_core`` / ``_ce_chunked_bwd``.  The largest live loss buffer is
  (B T, chunk).
- ``default_chunk``: the largest divisor of the vocabulary <= 1024.

The tensor-parallel head (``tp_axis`` / ``tp_size > 1``, the vocabulary
sharded over the model axis) is refused until slice 5d (ROADMAP.md queue 1).
Masking follows ``ops.nn.IGNORE_INDEX``: ignored positions add zero loss
and zero gradient.
"""

from __future__ import annotations

import torch

from .nn import IGNORE_INDEX, masked_ce

TP_HEAD_SLICE = ("ROADMAP.md queue 1, slice 5d (model parallelism: the "
                 "vocabulary-sharded head)")


def default_chunk(vocab: int, cap: int = 1024) -> int:
    """Largest divisor of ``vocab`` that is <= ``cap``: the chunk used when
    ``loss_chunk`` is left unset."""
    if vocab <= 0:
        raise ValueError(f"vocab must be positive, got {vocab}")
    for c in range(min(cap, vocab), 0, -1):
        if vocab % c == 0:
            return c
    return 1


def _flat(h: torch.Tensor, targets: torch.Tensor):
    """(n, D) float32 hidden states, (n,) targets, the mask and the targets
    with ignored positions at 0."""
    h2 = h.reshape(-1, h.shape[-1]).float()
    t = targets.reshape(-1)
    mask = t != IGNORE_INDEX
    return h2, t, mask, torch.where(mask, t, torch.zeros_like(t)).long()


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, emb, targets, chunk):
        h2, _, mask, safe = _flat(h, targets)
        n = h2.shape[0]
        m = torch.full((n,), -torch.inf, device=h.device)
        s = torch.zeros((n,), device=h.device)
        tl = torch.zeros((n,), device=h.device)
        for c0 in range(0, emb.shape[0], chunk):
            lg = h2 @ emb[c0:c0 + chunk].float().T   # the only (n, chunk)
            m_new = torch.maximum(m, lg.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                lg - m_new[:, None]).sum(-1)
            m = m_new
            idx = safe - c0
            own = (idx >= 0) & (idx < chunk)
            got = torch.gather(lg, 1, idx.clamp(0, chunk - 1)[:, None])[:, 0]
            tl = tl + torch.where(own, got, torch.zeros_like(got))
        lse = m + torch.log(s)
        ce = torch.where(mask, lse - tl, torch.zeros_like(lse))
        ctx.save_for_backward(h, emb, targets, lse)
        ctx.chunk = chunk
        return ce.sum()

    @staticmethod
    def backward(ctx, g):
        h, emb, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        h2, _, mask, safe = _flat(h, targets)
        cols = torch.arange(chunk, device=h.device)
        keep = mask[:, None].float()
        dh = torch.zeros_like(h2)
        dws = []
        for c0 in range(0, emb.shape[0], chunk):
            w32 = emb[c0:c0 + chunk].float()
            p = torch.exp(h2 @ w32.T - lse[:, None])        # softmax slice
            onehot = (cols[None, :] == (safe - c0)[:, None]).float()
            coeff = g * (p - onehot) * keep                  # (n, chunk)
            dh = dh + coeff @ w32
            dws.append(coeff.T @ h2)                         # (chunk, D)
        demb = torch.cat(dws).to(emb.dtype)
        return dh.reshape(h.shape).to(h.dtype), demb, None, None


def masked_ce_chunked(h: torch.Tensor, emb: torch.Tensor,
                      targets: torch.Tensor, *, chunk: int,
                      tp_axis=None, tp_size: int = 1):
    """Streaming masked cross-entropy: ``(sum of CE, #unmasked tokens)``
    over ``logits = h @ emb.T`` without the logits.  ``chunk`` must divide
    the vocabulary rows.  Matches ``masked_ce`` on the same logits to ~1e-6
    (online against one-shot logsumexp rounding)."""
    if tp_axis is not None and tp_size > 1:
        raise NotImplementedError(
            "the tensor-parallel chunked head (tp_axis, tp_size > 1) is not "
            f"ported to PyTorch yet: {TP_HEAD_SLICE}")
    v_local = emb.shape[0]
    if chunk <= 0 or v_local % chunk:
        raise ValueError(
            f"loss_chunk {chunk} must be a positive divisor of the "
            f"per-rank vocab rows {v_local} (vocab {emb.shape[0]}) — the "
            "scan needs equal-sized chunks")
    ce_sum = _ChunkedCE.apply(h, emb, targets, int(chunk))
    return ce_sum, (targets != IGNORE_INDEX).sum()


def head_loss(h: torch.Tensor, emb: torch.Tensor, targets: torch.Tensor, *,
              loss_impl: str = "dense", loss_chunk: int | None = None,
              tp_axis=None, tp_size: int = 1):
    """Final-norm hidden states + tied embedding -> ``(sum of masked CE,
    #unmasked tokens)``: float32 ``h @ emb.T`` then ``masked_ce``
    (``"dense"``), or the streamed ``masked_ce_chunked`` with
    ``loss_chunk`` (default ``default_chunk`` of the vocabulary)."""
    if tp_axis is not None and tp_size > 1:
        raise NotImplementedError(
            "the tensor-parallel head (tp_axis, tp_size > 1) is not ported "
            f"to PyTorch yet: {TP_HEAD_SLICE}")
    if loss_impl == "chunked":
        chunk = loss_chunk if loss_chunk else default_chunk(emb.shape[0])
        return masked_ce_chunked(h, emb, targets, chunk=chunk)
    if loss_impl != "dense":
        raise ValueError(f"unknown loss_impl {loss_impl!r}: expected 'dense' "
                         "or 'chunked'")
    logits = h.float() @ emb.float().T
    return masked_ce(logits, targets)
