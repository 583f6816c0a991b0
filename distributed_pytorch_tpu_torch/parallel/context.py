"""Ring attention, sequence parallelism over a process group: the port of
the JAX package's parallel/context.py.

Sequences are sharded over the ``seq`` axis of the LM mesh; each rank holds
a chunk of Q/K/V.  Attention over the whole sequence runs in ``n`` ring
steps: at step t a rank attends its Q chunk against the K/V chunk that
started on rank ``(me - t) mod n``, having received it from its left
neighbour, and the partial results are merged by the online-softmax rule
(``_merge``: each partial is normalized within its key chunk and carries
its row logsumexp).  The chunk pair attentions run through the flash
kernels (``impl="flash"``: K2 forward, K3/K4 backward on the GPU, with an
lse output whose cotangent the backward folds into delta) or the plain
``attention_reference``.

Layouts, as in the JAX package:

- ``contiguous``: rank r holds positions [r S_loc, (r + 1) S_loc).  A ring
  step whose source chunk lies after the rank's own is fully masked; the
  JAX ring runs it in SPMD lockstep and merges a (0, NEG_INF) partial.
  Here ``me``, ``t`` and the source are Python ints, so such a step skips
  its attention (merging a NEG_INF partial is an exact identity) but never
  its shift: every rank passes its K/V on at every step.
- ``zigzag``: the sequence is cut into 2n chunks and rank r holds chunks
  [r, 2n - 1 - r]; every step is two half-chunk non-causal attentions on
  every rank (``zigzag_permutation`` lays tokens out, ``zigzag_positions``
  gives their rotary positions).

The exchange is the only thing a rank's driver supplies (a ``Ring``):

- ``GroupRing(group)``: one process a rank.  JAX's ``lax.ppermute`` to the
  right neighbour becomes ``_Shift``, an autograd function that sends K and
  V right and receives from the left in one ``batch_isend_irecv``; its
  backward shifts the cotangents left.  A rank whose last steps are all
  masked (contiguous) uses no shifted chunk, so ``_Tie`` hangs the last
  shift's outputs on the ring's output: every rank's backward then runs
  every shift, in the same order.
- ``LoopbackRing(me, ks, vs)``: every rank of the ring in one process (a
  test, or the chip script's single card): rank ``me``'s chunk at step t
  IS rank ``(me - t) mod n``'s original chunk, taken from ``ks``/``vs``,
  so autograd sums each chunk's gradient from every rank that used it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..ops.attention import NEG_INF, attention_reference, flash_attention

# -- zigzag layout helpers (host-side) ----------------------------------------


def zigzag_permutation(n: int, s: int) -> np.ndarray:
    """Index permutation laying a length-``s`` sequence out for an n-way
    zigzag ring: position j of the permuted sequence holds original position
    ``perm[j]``; its contiguous n-way split gives rank r chunks
    [r, 2n - 1 - r].  ``s`` must divide into 2n equal chunks."""
    if s % (2 * n):
        raise ValueError(f"sequence length {s} not divisible into {2 * n} "
                         f"zigzag chunks")
    c = s // (2 * n)
    idx = []
    for r in range(n):
        idx.append(np.arange(r * c, (r + 1) * c))
        idx.append(np.arange((2 * n - 1 - r) * c, (2 * n - r) * c))
    return np.concatenate(idx)


def inverse_zigzag_permutation(n: int, s: int) -> np.ndarray:
    """Inverse of ``zigzag_permutation`` (restores the original order)."""
    perm = zigzag_permutation(n, s)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(s)
    return inv


def zigzag_positions(me: int, n: int, s_local: int,
                     device: str | torch.device | None = None
                     ) -> torch.Tensor:
    """Global positions (int64, (s_local,)) of rank ``me``'s zigzag chunk
    pair: chunk ``me`` then chunk ``2n - 1 - me``, each s_local / 2 long."""
    c = s_local // 2
    lo = me * c + torch.arange(c, device=device)
    hi = (2 * n - 1 - me) * c + torch.arange(c, device=device)
    return torch.cat([lo, hi])


# -- the online-softmax merge -------------------------------------------------


def _merge(o1, lse1, o2, lse2):
    """Two normalized partial attentions, (B, H, S, D) outputs with their
    (B, H, S) logsumexps, combined; a NEG_INF partial vanishes."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse)[..., None]
    w2 = torch.exp(lse2 - lse)[..., None]
    return o1 * w1 + o2 * w2, lse


def _attn(q, k, v, *, causal: bool, sm_scale: float, impl: str):
    """One chunk pair's attention: (float32 o, lse) for the merge."""
    if impl == "flash":
        o, lse = flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                 with_lse=True)
    else:
        o, lse = attention_reference(q, k, v, causal=causal,
                                     sm_scale=sm_scale, with_lse=True)
    return o.float(), lse


# -- the exchange -------------------------------------------------------------


def _p2p(group, tensors: list, step: int) -> list:
    """Each of ``tensors`` sent ``step`` ranks along ``group`` and the
    matching ones received from ``-step`` ranks away, in one batch."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, dst, group, tag=i)
           for i, t in enumerate(tensors)]
    ops += [dist.P2POp(dist.irecv, o, src, group, tag=i)
            for i, o in enumerate(outs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class _Shift(torch.autograd.Function):
    """(k, v) passed to the right neighbour of ``group`` (received from the
    left); the backward passes the cotangents left."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        return tuple(_p2p(group, [k, v], 1))

    @staticmethod
    def backward(ctx, dk, dv):
        return (None, *_p2p(ctx.group, [dk, dv], -1))


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``k``/``v`` as inputs of no gradient, so that
    the backward reaches the shift that made them on every rank."""

    @staticmethod
    def forward(ctx, out, k, v):
        ctx.like = [(t.shape, t.dtype, t.device) for t in (k, v)]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.like))


class GroupRing:
    """The ring over a process group, one process a rank."""

    def __init__(self, group):
        self.group = group
        self.me = dist.get_rank(group)
        self.n = dist.get_world_size(group)

    def exchange(self, k, v, t: int):
        """The K/V chunk in hand after rotation t."""
        return _Shift.apply(self.group, k, v)

    def finish(self, out, k, v):
        return _Tie.apply(out, k, v)


class LoopbackRing:
    """Every rank of an n-rank ring in one process: rank ``me``'s chunk
    after rotation t is ``ks[(me - t) % n]`` (and ``vs``'s)."""

    def __init__(self, me: int, ks: list, vs: list):
        self.me, self.n = me, len(ks)
        self.ks, self.vs = ks, vs

    def exchange(self, k, v, t: int):
        src = (self.me - t) % self.n
        return self.ks[src], self.vs[src]

    def finish(self, out, k, v):
        return out


def as_ring(axis):
    """A ``GroupRing`` of a process group; a ring passes through."""
    return axis if isinstance(axis, (GroupRing, LoopbackRing)) \
        else GroupRing(axis)


# -- ring attention -----------------------------------------------------------


def ring_attention(q, k, v, axis, *, causal: bool = True,
                   sm_scale: float | None = None, impl: str = "reference",
                   layout: str = "contiguous"):
    """Attention over a sequence sharded across ``axis`` (a process group,
    or a ``GroupRing`` / ``LoopbackRing``).  ``q``/``k``/``v`` are this
    rank's chunks (B, H, S_local, D), laid out per ``layout``; equal to
    full attention over the concatenated sequence (non-causal attention
    does not depend on the layout)."""
    if impl not in ("reference", "flash"):
        raise ValueError(f"impl must be 'reference' or 'flash', got {impl!r}")
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"layout must be 'contiguous' or 'zigzag', "
                         f"got {layout!r}")
    ring = as_ring(axis)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if ring.n == 1:
        o, _ = _attn(q, k, v, causal=causal, sm_scale=sm_scale, impl=impl)
        return o.to(q.dtype)
    if causal and layout == "zigzag":
        return _ring_zigzag(q, k, v, ring, sm_scale=sm_scale, impl=impl)
    return _ring_contiguous(q, k, v, ring, causal=causal, sm_scale=sm_scale,
                            impl=impl)


def _ring_contiguous(q, k, v, ring, *, causal, sm_scale, impl):
    me, n = ring.me, ring.n
    # the diagonal (t = 0): the rank's own chunk, causal (or full)
    acc, lse_acc = _attn(q, k, v, causal=causal, sm_scale=sm_scale,
                         impl=impl)
    k_t, v_t = k, v
    for t in range(1, n):
        # after t rotations the chunk in hand started on src = (me - t) % n
        k_t, v_t = ring.exchange(k_t, v_t, t)
        if causal and (me - t) % n > me:
            continue  # later chunk: fully masked, its merge the identity
        o_t, lse_t = _attn(q, k_t, v_t, causal=False, sm_scale=sm_scale,
                           impl=impl)
        acc, lse_acc = _merge(acc, lse_acc, o_t, lse_t)
    return ring.finish(acc.to(q.dtype), k_t, v_t)


def _ring_zigzag(q, k, v, ring, *, sm_scale, impl):
    """The causal ring over the zigzag layout.  The rank's halves are
    chunks lo = ``me`` and hi = ``2n - 1 - me``; the K/V in hand at step t
    came from src with halves c_lo = src, c_hi = 2n - 1 - src.  Two of the
    four pairs are visible: (q_lo, c_lo) and (q_hi, c_lo) when src < me,
    else (q_hi, c_lo) and (q_hi, c_hi), merged first (JAX's order) then
    into the hi accumulator; the lo accumulator's JAX merge with a NEG_INF
    partial is skipped (an exact identity)."""
    me, n = ring.me, ring.n
    sq = q.shape[2]
    if sq % 2:
        raise ValueError(f"zigzag layout needs an even local sequence "
                         f"length, got {sq}")
    c = sq // 2
    q_lo, q_hi = q[:, :, :c], q[:, :, c:]
    kw = dict(causal=False, sm_scale=sm_scale, impl=impl)
    # the diagonal: causal over the rank's own [lo; hi] (all of lo precedes
    # all of hi, and each half is in order)
    o0, lse0 = _attn(q, k, v, causal=True, sm_scale=sm_scale, impl=impl)
    acc_lo, lse_lo = o0[:, :, :c], lse0[:, :, :c]
    acc_hi, lse_hi = o0[:, :, c:], lse0[:, :, c:]
    k_t, v_t = k, v
    for t in range(1, n):
        k_t, v_t = ring.exchange(k_t, v_t, t)
        k_lo, k_hi = k_t[:, :, :c], k_t[:, :, c:]
        v_lo, v_hi = v_t[:, :, :c], v_t[:, :, c:]
        if (me - t) % n < me:  # an earlier rank's chunk pair
            o1, lse1 = _attn(q_lo, k_lo, v_lo, **kw)
            o2, lse2 = _attn(q_hi, k_lo, v_lo, **kw)
            acc_lo, lse_lo = _merge(acc_lo, lse_lo, o1, lse1)
            acc_hi, lse_hi = _merge(acc_hi, lse_hi, o2, lse2)
        else:
            o1, lse1 = _attn(q_hi, k_lo, v_lo, **kw)
            o2, lse2 = _attn(q_hi, k_hi, v_hi, **kw)
            om, lsem = _merge(o1, lse1, o2, lse2)
            acc_hi, lse_hi = _merge(acc_hi, lse_hi, om, lsem)
    out = torch.cat([acc_lo, acc_hi], dim=2).to(q.dtype)
    return ring.finish(out, k_t, v_t)


def ring_launches(n: int, layout: str, causal: bool = True) -> list[int]:
    """Chunk-pair attentions (flash forwards, and so K3 and K4 launches in
    the backward) each of the ``n`` ranks runs in one ring: zigzag
    ``2n - 1``; contiguous causal ``1 + r`` on rank r (its masked steps
    skipped), non-causal ``n``."""
    if n == 1:
        return [1]
    if causal and layout == "zigzag":
        return [2 * n - 1] * n
    return [1 + r if causal else n for r in range(n)]
