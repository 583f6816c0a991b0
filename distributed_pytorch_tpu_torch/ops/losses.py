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

The tensor-parallel chunked head (``tp_axis``, a process group, and
``tp_size > 1``): each rank streams only its ``V / tp`` vocabulary rows,
cut from the replicated embedding at its rank in the group, and the
partial logsumexps combine with one max and one sum all-reduce over the
group (the JAX ``pmax`` + ``psum``), the target logit (owned by one rank)
with another sum; the backward sums the hidden-state gradient over the
group and all-gathers the embedding gradient's row blocks, so both come
back replicated, as the dense head's are.  The dense head ignores the
tensor axis (each rank computes the full logits of its replicated hidden
states), as in the JAX package.
Masking follows ``ops.nn.IGNORE_INDEX``: ignored positions add zero loss
and zero gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .nn import IGNORE_INDEX, masked_ce


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


def _local_rows(emb: torch.Tensor, group, tp_size: int):
    """This rank's vocabulary rows of the replicated embedding and their
    global offset (0 and the whole embedding without a tensor axis)."""
    if group is None:
        return emb, 0
    v_local = emb.shape[0] // tp_size
    v0 = dist.get_rank(group) * v_local
    return emb[v0:v0 + v_local], v0


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, emb, targets, chunk, group, tp_size):
        h2, _, mask, safe = _flat(h, targets)
        emb_l, v0 = _local_rows(emb, group, tp_size)
        n = h2.shape[0]
        m = torch.full((n,), -torch.inf, device=h.device)
        s = torch.zeros((n,), device=h.device)
        tl = torch.zeros((n,), device=h.device)
        for c0 in range(0, emb_l.shape[0], chunk):
            lg = h2 @ emb_l[c0:c0 + chunk].float().T   # the only (n, chunk)
            m_new = torch.maximum(m, lg.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                lg - m_new[:, None]).sum(-1)
            m = m_new
            idx = safe - (v0 + c0)
            own = (idx >= 0) & (idx < chunk)
            got = torch.gather(lg, 1, idx.clamp(0, chunk - 1)[:, None])[:, 0]
            tl = tl + torch.where(own, got, torch.zeros_like(got))
        if group is not None:
            # the per-rank partial logsumexps and the one owned target
            # logit combined over the tensor axis
            mg = m.clone()
            dist.all_reduce(mg, op=dist.ReduceOp.MAX, group=group)
            sg = s * torch.exp(m - mg)
            dist.all_reduce(sg, group=group)
            lse = mg + torch.log(sg)
            dist.all_reduce(tl, group=group)
        else:
            lse = m + torch.log(s)
        ce = torch.where(mask, lse - tl, torch.zeros_like(lse))
        ctx.save_for_backward(h, emb, targets, lse)
        ctx.chunk, ctx.group, ctx.tp_size = chunk, group, tp_size
        return ce.sum()

    @staticmethod
    def backward(ctx, g):
        h, emb, targets, lse = ctx.saved_tensors
        chunk, group = ctx.chunk, ctx.group
        h2, _, mask, safe = _flat(h, targets)
        emb_l, v0 = _local_rows(emb, group, ctx.tp_size)
        cols = torch.arange(chunk, device=h.device)
        keep = mask[:, None].float()
        dh = torch.zeros_like(h2)
        dws = []
        for c0 in range(0, emb_l.shape[0], chunk):
            w32 = emb_l[c0:c0 + chunk].float()
            p = torch.exp(h2 @ w32.T - lse[:, None])        # softmax slice
            onehot = (cols[None, :] == (safe - (v0 + c0))[:, None]).float()
            coeff = g * (p - onehot) * keep                  # (n, chunk)
            dh = dh + coeff @ w32
            dws.append(coeff.T @ h2)                         # (chunk, D)
        demb = torch.cat(dws)
        if group is not None:
            # the partial dh of each rank's rows summed, the row blocks of
            # demb gathered: both replicated, like the dense head's
            dist.all_reduce(dh, group=group)
            full = torch.empty((ctx.tp_size * demb.shape[0], demb.shape[1]),
                               dtype=demb.dtype, device=demb.device)
            _all_gather(full, demb, group)
            demb = full
        return (dh.reshape(h.shape).to(h.dtype), demb.to(emb.dtype), None,
                None, None, None)


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """The row blocks of ``x`` from every rank of ``group`` into ``out``."""
    from ..parallel.strategies import all_gather_flat
    all_gather_flat(out.view(-1), x.contiguous().view(-1), group=group)


def _tp(tp_axis, tp_size: int):
    """The tensor axis's group when the head is vocabulary-sharded."""
    return tp_axis if tp_axis is not None and tp_size > 1 else None


def masked_ce_chunked(h: torch.Tensor, emb: torch.Tensor,
                      targets: torch.Tensor, *, chunk: int,
                      tp_axis=None, tp_size: int = 1):
    """Streaming masked cross-entropy: ``(sum of CE, #unmasked tokens)``
    over ``logits = h @ emb.T`` without the logits.  ``chunk`` must divide
    this rank's vocabulary rows (``V``, or ``V / tp_size`` with the
    vocabulary sharded over ``tp_axis``, a process group of ``tp_size``
    ranks).  Matches ``masked_ce`` on the same logits to ~1e-6 (online
    against one-shot logsumexp rounding)."""
    group = _tp(tp_axis, tp_size)
    v_local = emb.shape[0] // (tp_size if group is not None else 1)
    if chunk <= 0 or v_local % chunk:
        raise ValueError(
            f"loss_chunk {chunk} must be a positive divisor of the "
            f"per-rank vocab rows {v_local} (vocab {emb.shape[0]}"
            + (f" over the {tp_size}-way tp head" if group is not None
               else "")
            + ") — the scan needs equal-sized chunks")
    ce_sum = _ChunkedCE.apply(h, emb, targets, int(chunk), group,
                              int(tp_size))
    return ce_sum, (targets != IGNORE_INDEX).sum()


def head_loss(h: torch.Tensor, emb: torch.Tensor, targets: torch.Tensor, *,
              loss_impl: str = "dense", loss_chunk: int | None = None,
              tp_axis=None, tp_size: int = 1):
    """Final-norm hidden states + tied embedding -> ``(sum of masked CE,
    #unmasked tokens)``: float32 ``h @ emb.T`` then ``masked_ce``
    (``"dense"``, which ignores the tensor axis), or the streamed
    ``masked_ce_chunked`` with ``loss_chunk`` (default ``default_chunk`` of
    the per-rank vocabulary rows), vocabulary-sharded over ``tp_axis``
    when ``tp_size > 1``."""
    if loss_impl == "chunked":
        v_local = emb.shape[0] // (tp_size if tp_axis is not None else 1)
        chunk = loss_chunk if loss_chunk else default_chunk(v_local)
        return masked_ce_chunked(h, emb, targets, chunk=chunk,
                                 tp_axis=tp_axis, tp_size=tp_size)
    if loss_impl != "dense":
        raise ValueError(f"unknown loss_impl {loss_impl!r}: expected 'dense' "
                         "or 'chunked'")
    logits = h.float() @ emb.float().T
    return masked_ce(logits, targets)
