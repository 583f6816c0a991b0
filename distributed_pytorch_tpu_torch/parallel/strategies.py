"""Gradient-synchronization strategies: the port of the JAX package's
parallel/strategies.py.

Each strategy is a callable over the list of one rank's gradient tensors
and the group it syncs over (a ``DeviceMesh`` from ``mesh.make_mesh``, or a
process group), run between ``loss.backward()`` and ``optimizer.step()``
(reference main_all_reduce.py:36-50).  The collectives are
``torch.distributed``'s (NCCL on the card, Gloo on the CPU): the
counterparts of the collectives XLA emits for the JAX strategies, not of a
Pallas kernel.  The registry holds the JAX package's ten names:

- ``none``       -- identity; the single-process baseline (main.py).
- ``all_reduce`` -- one all-reduce a tensor, in order, sum then ``/ n``
                    (main_all_reduce.py:45-48: 34 collectives a VGG-11 step).
- ``gather_scatter`` -- per tensor, ``gather`` to rank 0, the rank-ordered
                    sum ``g0 + g1 + ...`` there, ``/ n``, ``scatter`` back
                    (main_gather.py:42-59: all traffic through rank 0).
- ``gather_scatter_symmetric`` -- per tensor, ``all_gather`` and every rank
                    takes the mean: no rank-0 hotspot.
- ``ddp``        -- the whole-tree mean as one coalesced all-reduce over the
                    flattened gradients, after the backward: XLA combines the
                    JAX strategy's whole-tree ``pmean`` the same way.  Not
                    ``DistributedDataParallel``, whose Reducer overlaps the
                    sync with the backward (the JAX ``overlap=True``).
- ``bucketed``   -- ``make_bucket_plan``'s ~25 MB buckets, one flat
                    all-reduce a bucket (torch DDP's bucket_cap_mb=25).
- ``quantized``  -- per tensor, a scale shared through ``all_reduce(MAX)`` of
                    max|g|, int8 values summed as int32, dequantized, ``/ n``.
- ``quantized_ring`` -- a ring reduce-scatter then all-gather over
                    ``batch_isend_irecv`` whose payloads are int8 (or
                    nibble-packed int4) values with one f32 scale a
                    256-value block.
- ``quantized_ring_ef`` -- the ring plus error feedback: each rank's dropped
                    quantization error is a residual carried to the next step.
- ``hierarchical`` -- over a ``("dcn", "ici")`` mesh: reduce-scatter over
                    ``ici``, a shard-sized all-reduce over ``dcn``, all-gather
                    over ``ici``, the f32 sum scaled by ``1/n``; with
                    ``dcn_compress`` the ``dcn`` hop is the int8 (int4)
                    ring with an error-feedback residual.

The strategies that pack leaves into one flat vector (``make_bucket_plan``,
``bucketed``, the rings, ``hierarchical``) concatenate them in the order
given.  The trainer hands every strategy its leaves in the JAX package's
tree order (sorted keys), and the rings each leaf in the JAX layout (conv
kernels HWIO), so that a ring's block scales group the same values as the
JAX ring's.  A division by a constant (the mean's ``n``, the quantization
levels 127 and 7) is a multiplication by its float32 reciprocal, as XLA
compiles the JAX strategies' ``/ n`` and ``/ levels``.  A strategy may
overwrite the tensors it is given; it returns the synced list.

**Overlap** (``OverlapSync``): each bucket's collective runs inside the
backward, from a sync point (``sync_boundary``) that the model places at
the bucket's earliest layer-group boundary: an identity in the forward
whose backward syncs the cotangents autograd has summed into it.  On the
card the collective is issued on a side stream (``_InFlight``), so the
backward kernels of the earlier layers run while it is in flight; the
synced gradients reach ``.grad`` in a callback at the end of the backward,
after the default stream has waited on the side stream, and nothing reads
them before.

**Sync windows** (``sync_every > 1``): ``require_sync_window`` is the one
coherence check of both trainers and both CLIs; ``Hierarchical`` adds the
window's two halves, ``local_sync`` (the within-slice mean of a local
step) and ``window_exchange`` (the cross-slice mean of the accumulated
delta at a boundary); ``OuterOptimizer`` is the DiLoCo outer step of a
boundary.  ``RoutedSync``, ``auto`` and ``routed`` belong to slice 5f.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..utils import faults


BUCKET_CAP_MB = 25  # torch DDP default bucket size

# The flat (single-tensor) gather and reduce-scatter: torch 2.13 names them
# ``*_single`` and deprecates the ``*_tensor`` names that earlier releases
# have alone.
all_gather_flat = (getattr(dist, "all_gather_single", None)
                   or dist.all_gather_into_tensor)
reduce_scatter_flat = (getattr(dist, "reduce_scatter_single", None)
                       or dist.reduce_scatter_tensor)


class SizedLeaf:
    """The two attributes ``make_bucket_plan`` reads (``size`` and
    ``dtype.itemsize``), without a tensor: for planning buckets from shapes
    alone."""

    __slots__ = ("size", "dtype")

    def __init__(self, size: int, dtype):
        self.size = int(size)
        self.dtype = np.dtype(dtype)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return leaf.size * leaf.dtype.itemsize


def _numel(leaf) -> int:
    return leaf.numel() if isinstance(leaf, torch.Tensor) else leaf.size


def make_bucket_plan(leaves: list, bucket_bytes: int) -> list[list[int]]:
    """Pack leaf indices into ~``bucket_bytes`` buckets in REVERSE order
    (torch DDP's Reducer packing: the output-side gradients fill the first
    bucket), indices ascending within each bucket: the JAX package's plan,
    index for index."""
    buckets: list[list[int]] = [[]]
    size = 0
    for i in reversed(range(len(leaves))):
        nbytes = _nbytes(leaves[i])
        if size + nbytes > bucket_bytes and buckets[-1]:
            buckets.append([])
            size = 0
        buckets[-1].append(i)
        size += nbytes
    return [sorted(b) for b in buckets]


# -- groups -------------------------------------------------------------------

def flat_group(axis):
    """The process group of a flat strategy's ``axis``: a 1-D
    ``DeviceMesh``, a process group, or None (the default group)."""
    if isinstance(axis, DeviceMesh):
        if axis.ndim != 1:
            raise ValueError(f"a flat strategy needs a 1-D mesh, got axes "
                             f"{axis.mesh_dim_names}")
        return axis.get_group()
    return axis


def _size(group) -> int:
    return dist.get_world_size(group)


def _peer(group, r: int) -> int:
    """Global rank of ``group``'s rank ``r``."""
    return r if group is None else dist.get_global_rank(group, r)


def _split(flat: torch.Tensor, leaves: list) -> list:
    """``flat`` cut back into the leaves' shapes and dtypes."""
    out, offset = [], 0
    for g in leaves:
        out.append(flat[offset:offset + g.numel()].reshape(g.shape)
                   .to(g.dtype))
        offset += g.numel()
    return out


def _flat(leaves: list, dtype=None) -> torch.Tensor:
    """The leaves raveled in order (each in its logical, row-major order)
    and concatenated."""
    return torch.cat([g.reshape(-1) if dtype is None
                      else g.reshape(-1).to(dtype) for g in leaves])


def flat_all_reduce(leaves: list, axis, scale: float | None = None) -> list:
    """The leaves summed over ``axis``'s ranks in ONE all-reduce of their
    flat concatenation (``ddp``'s collective), times ``scale`` if given,
    cut back into their shapes.  The sum is elementwise across ranks, so
    the result does not depend on how the leaves are packed."""
    group = flat_group(axis)
    flat = _flat(leaves)
    dist.all_reduce(flat, group=group)
    if scale is not None:
        flat.mul_(scale)
    return _split(flat, leaves)


# -- the strategies ------------------------------------------------------------

class NoSync:
    """Single-process baseline: no communication (reference main.py)."""

    name = "none"
    needs_mesh = False

    def __call__(self, grads: list, axis=None) -> list:
        return grads


class AllReduce:
    """One all-reduce a tensor, in order, then ``/ n``
    (main_all_reduce.py:45-48): ``psum / n`` of the JAX strategy."""

    name = "all_reduce"
    needs_mesh = True

    def __call__(self, grads: list, axis) -> list:
        group = flat_group(axis)
        n = _size(group)
        for g in grads:
            dist.all_reduce(g, group=group)
            g.mul_(1.0 / n)
        return grads


class GatherScatter:
    """Per tensor: ``gather`` to rank 0, the sum in rank order there (the
    JAX strategy's ``acc = g0 + g1 + ...``), ``/ n``, and ``scatter`` of the
    mean back to every rank (main_gather.py:42-59): every byte crosses rank
    0, the parameter-server baseline."""

    name = "gather_scatter"
    needs_mesh = True

    def __call__(self, grads: list, axis) -> list:
        group = flat_group(axis)
        n = _size(group)
        root = _peer(group, 0)
        me = dist.get_rank(group)
        out = []
        for g in grads:
            g = g.contiguous()
            gathered = ([torch.empty_like(g) for _ in range(n)]
                        if me == 0 else None)
            dist.gather(g, gathered, dst=root, group=group)
            if me == 0:
                acc = gathered[0]
                for r in range(1, n):
                    acc = acc + gathered[r]
                mean = acc * (1.0 / n)
            result = torch.empty_like(g)
            dist.scatter(result, [mean] * n if me == 0 else None, src=root,
                         group=group)
            out.append(result)
        return out


class GatherScatterSymmetric:
    """The same mean through symmetric collectives: per tensor an
    ``all_gather``, then every rank means the gathered copies itself (the
    same values in the same order, so the same result on every rank); no
    rank-0 hotspot."""

    name = "gather_scatter_symmetric"
    needs_mesh = True

    def __call__(self, grads: list, axis) -> list:
        group = flat_group(axis)
        n = _size(group)
        out = []
        for g in grads:
            g = g.contiguous()
            gathered = [torch.empty_like(g) for _ in range(n)]
            dist.all_gather(gathered, g, group=group)
            out.append(torch.stack(gathered).sum(0) * (1.0 / n))
        return out


class Bucketed:
    """DDP-style bucketing: ``make_bucket_plan``'s buckets, one flat
    all-reduce a bucket, ``/ n`` (torch DDP's Reducer with
    bucket_cap_mb=25)."""

    name = "bucketed"
    needs_mesh = True
    supports_overlap = True

    def __init__(self, bucket_mb: float = BUCKET_CAP_MB):
        self.bucket_bytes = int(bucket_mb * 1024 * 1024)

    def sync_bucket(self, leaves: list, axis) -> list:
        """One packed all-reduce mean over these leaves."""
        return flat_all_reduce(leaves, axis,
                               1.0 / _size(flat_group(axis)))

    def __call__(self, grads: list, axis) -> list:
        out: list = [None] * len(grads)
        for bucket in make_bucket_plan(grads, self.bucket_bytes):
            synced = self.sync_bucket([grads[i] for i in bucket], axis)
            for i, s in zip(bucket, synced):
                out[i] = s
        return out


class DDP(Bucketed):
    """The whole-tree mean, after the backward, as ONE coalesced all-reduce
    over every gradient flattened (``pmean`` over the whole tree in the JAX
    package, which XLA combines likewise): one collective a step."""

    name = "ddp"
    needs_mesh = True
    supports_overlap = True  # overlap packs make_bucket_plan's buckets

    def __call__(self, grads: list, axis) -> list:
        return self.sync_bucket(grads, axis)


class QuantizedAllReduce:
    """Int8-quantized all-reduce: per tensor a symmetric int8 quantization
    against a scale shared through ``all_reduce(MAX)`` of max|g|, the int8
    values summed exactly as int32, dequantized, ``/ n``.  Two collectives
    a tensor; int32 on the wire, as in the JAX strategy."""

    name = "quantized"
    needs_mesh = True
    supports_overlap = True
    bucket_bytes = BUCKET_CAP_MB * 1024 * 1024  # overlap grouping only

    def __init__(self, bits: int = 8):
        self.levels = 2 ** (bits - 1) - 1  # 127 for int8

    def _sync_leaf(self, g: torch.Tensor, group, n: int) -> torch.Tensor:
        g32 = g.float()
        absmax = g32.abs().amax().reshape(1)
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp_min(absmax * (1.0 / self.levels), 1e-30)
        q = torch.clamp(torch.round(g32 / scale), -self.levels,
                        self.levels).to(torch.int8)
        summed = q.to(torch.int32)
        dist.all_reduce(summed, group=group)
        return (summed.float() * scale * (1.0 / n)).to(g.dtype)

    def __call__(self, grads: list, axis) -> list:
        group = flat_group(axis)
        n = _size(group)
        return [self._sync_leaf(g, group, n) for g in grads]

    def sync_bucket(self, leaves: list, axis) -> list:
        """Per leaf, as ``__call__``: the scale is a tensor's, so the
        bucket grouping changes nothing."""
        return self(leaves, axis)


class QuantizedRing:
    """Int8 (or int4) ring all-reduce with compressed payloads: a ring
    reduce-scatter then a ring all-gather over ``batch_isend_irecv`` to
    ``(r + 1) % n``, each hop carrying int8 values (int4: two nibbles a
    byte, low nibble first) and one f32 scale a ``block`` of values.  Each
    reduce-scatter hop requantizes its partial sum; the all-gather forwards
    each reduced chunk's payload as it is.  One ring per
    ``make_bucket_plan`` bucket; a ring of one rank has no hop and returns
    the gradients as they are (as the JAX strategy does at n = 1)."""

    name = "quantized_ring"
    needs_mesh = True
    supports_overlap = True

    def __init__(self, bits: int = 8, block: int = 256,
                 bucket_mb: float = BUCKET_CAP_MB):
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        self.bits = bits
        self.levels = 2 ** (bits - 1) - 1  # 127 at int8, 7 at int4
        self.block = block
        self.bucket_bytes = int(bucket_mb * 1024 * 1024)

    def _plan(self, leaves: list) -> list[list[int]]:
        return make_bucket_plan(leaves, self.bucket_bytes)

    def _chunk(self, total: int, n: int) -> int:
        """Per-rank ring chunk (block-aligned) of a ``total``-element flat
        vector over an ``n``-way ring."""
        return -(-total // (n * self.block)) * self.block

    def _quant(self, x: torch.Tensor):
        xb = x.reshape(-1, self.block)
        scale = torch.clamp_min(xb.abs().amax(1, keepdim=True)
                                * (1.0 / self.levels), 1e-30)
        q = torch.clamp(torch.round(xb / scale), -self.levels,
                        self.levels).to(torch.int8)
        return q, scale

    @staticmethod
    def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return (q.float() * scale).reshape(-1)

    @staticmethod
    def _dequant_add(q: torch.Tensor, scale: torch.Tensor, c: torch.Tensor,
                     sign: float = 1.0) -> torch.Tensor:
        """``c + sign * dequant(q, scale)`` rounded once: XLA's CPU backend
        contracts the JAX ring's ``q * s + c`` (and ``c - q * s``) into a
        fused multiply-add.  In float64 the product of an int8 and a float32
        is exact, so the float32 result is the fused one (unless the sum
        needs more than 53 bits and rounds twice)."""
        prod = q.double() * scale.double()
        return (c.reshape(q.shape).double() + sign * prod).float() \
            .reshape(-1)

    @staticmethod
    def _pack(q: torch.Tensor) -> torch.Tensor:
        """(..., even) int4-valued int8 -> flat int8 of half the size, low
        nibble first."""
        u = q.reshape(-1, 2).view(torch.uint8) & 0xF
        return (u[:, 0] | (u[:, 1] << 4)).view(torch.int8)

    @staticmethod
    def _unpack(packed: torch.Tensor, shape) -> torch.Tensor:
        """Inverse of ``_pack``: both nibbles sign-extended to int8."""
        u = packed.view(torch.uint8)
        lo = ((u & 0xF).view(torch.int8) ^ 8) - 8
        hi = (((u >> 4) & 0xF).view(torch.int8) ^ 8) - 8
        return torch.stack([lo, hi], dim=-1).reshape(shape)

    def _hop(self, q: torch.Tensor, s: torch.Tensor, group, n: int,
             me: int):
        """Send (q, s) to the next rank of the ring and receive the
        previous rank's; at bits=4 the values travel nibble-packed."""
        payload = q if self.bits == 8 else self._pack(q)
        rq, rs = torch.empty_like(payload), torch.empty_like(s)
        nxt, prv = _peer(group, (me + 1) % n), _peer(group, (me - 1) % n)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, payload.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, rq, prv, group),
            dist.P2POp(dist.isend, s.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, rs, prv, group)])
        for r in reqs:
            r.wait()
        return (rq if self.bits == 8 else self._unpack(rq, q.shape)), rs

    def _ring_sum(self, flat: torch.Tensor, group, n: int,
                  residual: torch.Tensor | None = None):
        """The ring: reduce-scatter then all-gather.  Returns
        ``(summed[:total], err_rows)``: the approximate cross-rank SUM of
        ``flat`` and the (n, chunk) quantization errors this rank dropped.
        With ``residual`` (error feedback), last step's dropped errors are
        added to this step's chunk contributions first."""
        total = flat.numel()
        me = dist.get_rank(group)
        chunk = self._chunk(total, n)
        parts = F.pad(flat, (0, n * chunk - total)).reshape(n, chunk)
        if residual is not None:
            parts = parts + residual.reshape(n, chunk)
        # after t hops the accumulator holds the partial sum of chunk
        # (me - t) mod n over ranks {me - t, ..., me}
        acc = parts[me]
        err_rows = torch.zeros((n, chunk), dtype=torch.float32,
                               device=flat.device)
        for t in range(n - 1):
            q, s = self._quant(acc)
            err_rows[(me - t) % n] = self._dequant_add(q, s, acc, -1.0)
            q, s = self._hop(q, s, group, n, me)
            acc = self._dequant_add(q, s, parts[(me - t - 1) % n])
        # acc is the full sum of chunk (me + 1) mod n
        qf, sf = self._quant(acc)
        own = (me + 1) % n
        err_rows[own] = self._dequant_add(qf, sf, acc, -1.0)
        q_all = torch.zeros((n,) + tuple(qf.shape), dtype=torch.int8,
                            device=flat.device)
        s_all = torch.zeros((n,) + tuple(sf.shape), dtype=torch.float32,
                            device=flat.device)
        q_all[own], s_all[own] = qf, sf
        cur_q, cur_s = qf, sf
        for t in range(n - 1):
            cur_q, cur_s = self._hop(cur_q, cur_s, group, n, me)
            # the payload of hop t started at rank me - (t + 1): reduced
            # chunk (me - t) mod n
            src = (me - t) % n
            q_all[src], s_all[src] = cur_q, cur_s
        summed = (q_all.float() * s_all).reshape(-1)[:total]
        return summed, err_rows

    def sync_bucket(self, leaves: list, axis) -> list:
        """One ring over this bucket's flat vector (leaves in order)."""
        group = flat_group(axis)
        n = _size(group)
        flat = _flat(leaves, torch.float32)
        if n == 1:
            mean = flat
        else:
            summed, _ = self._ring_sum(flat, group, n)
            mean = summed * (1.0 / n)
        return _split(mean, leaves)

    def __call__(self, grads: list, axis) -> list:
        out: list = [None] * len(grads)
        for bucket in self._plan(grads):
            synced = self.sync_bucket([grads[i] for i in bucket], axis)
            for i, s in zip(bucket, synced):
                out[i] = s
        return out


class QuantizedRingEF(QuantizedRing):
    """``quantized_ring`` with error feedback: every quantization error the
    ring drops is kept by the rank that dropped it and added to the next
    step's contribution, so that ``n * mean + sum over ranks of the
    residuals`` is the exact gradient sum.

    State: one f32 vector a rank, the per-bucket padded residuals
    concatenated in bucket-plan order (``state_segments``), carried by the
    trainer from step to step."""

    name = "quantized_ring_ef"
    stateful = True

    def state_segments(self, leaves: list, n_axis: int) -> list[int]:
        """Per-bucket residual lengths (n_axis x the block-aligned chunk),
        in bucket-plan order."""
        return [n_axis * self._chunk(sum(_numel(leaves[i]) for i in bucket),
                                     n_axis)
                for bucket in self._plan(leaves)]

    def init_state(self, leaves: list, n_axis: int,
                   device: str | torch.device = "cpu") -> torch.Tensor:
        """This rank's zero residual for gradients shaped like ``leaves``
        over an ``n_axis``-way ring."""
        return torch.zeros(sum(self.state_segments(leaves, n_axis)),
                           dtype=torch.float32, device=device)

    def sync_bucket(self, leaves: list, axis, residual: torch.Tensor):
        """One error-feedback ring over this bucket; ``residual`` is the
        bucket's state segment, returned updated."""
        group = flat_group(axis)
        n = _size(group)
        flat = _flat(leaves, torch.float32)
        if n == 1:
            mean, new_res = flat, torch.zeros_like(residual)
        else:
            summed, err_rows = self._ring_sum(flat, group, n,
                                              residual=residual)
            mean, new_res = summed * (1.0 / n), err_rows.reshape(-1)
        return _split(mean, leaves), new_res

    def __call__(self, grads: list, axis, residual: torch.Tensor):
        n = _size(flat_group(axis))
        return sync_segments(
            grads, self._plan(grads), self.state_segments(grads, n),
            lambda j, vals, seg: self.sync_bucket(vals, axis, seg), residual)


def sync_segments(grads: list, buckets: list[list[int]], segs: list[int],
                  sync_fn: Callable, residual: torch.Tensor):
    """Each bucket's sync with its segment of an error-feedback residual,
    the segments taken and refilled in bucket order: ``sync_fn(j, leaves,
    segment) -> (synced, new segment)`` for bucket ``j``.  Returns ``(the
    synced leaves, the new residual)``."""
    out: list = [None] * len(grads)
    new_parts, offset = [], 0
    for j, (bucket, seg) in enumerate(zip(buckets, segs)):
        synced, new_r = sync_fn(j, [grads[i] for i in bucket],
                                residual[offset:offset + seg])
        offset += seg
        new_parts.append(new_r)
        for i, s in zip(bucket, synced):
            out[i] = s
    return out, torch.cat(new_parts) if new_parts else residual[:0]


def ring_reduce(ring: QuantizedRing, dcn, n_dcn: int,
                residual: torch.Tensor, out: dict) -> Callable:
    """The compressed slow hop: a ``shard -> summed shard`` callable (for
    ``two_level_psum``'s ``dcn_reduce``, or on a shard-sized bucket) that
    runs the exchange as ``ring`` over ``dcn``, ``residual`` added first,
    and records the error it dropped (the new residual) in
    ``out["res"]``."""
    def reduce(shard):
        if n_dcn == 1:  # nothing crosses, nothing is lost
            out["res"] = torch.zeros_like(residual)
            return shard
        summed, err_rows = ring._ring_sum(shard, dcn, n_dcn,
                                          residual=residual)
        out["res"] = err_rows.reshape(-1)
        return summed
    return reduce


def factor_groups(axis):
    """(dcn group or None, ici group) of ``axis``: a ``("dcn", "ici")``
    mesh, a 1-D mesh or a process group (one flat ``ici`` level), or a
    (dcn, ici) pair of groups."""
    if isinstance(axis, DeviceMesh):
        if axis.ndim == 1:
            return None, axis.get_group()
        names = axis.mesh_dim_names
        return axis.get_group(names[0]), axis.get_group(names[1])
    if isinstance(axis, tuple):
        return axis
    return None, axis


def two_level_psum(grads: list, dcn, ici, scale: float | None = None,
                   dcn_reduce: Callable | None = None) -> list:
    """The two-level reduction under ``Hierarchical``: the leaves as one
    f32 vector padded to a multiple of the ``ici`` size, a reduce-scatter
    over ``ici``, a shard-sized all-reduce over ``dcn`` (the only
    cross-slice traffic), an all-gather over ``ici``, the slice back to the
    true length, ``scale`` applied to the f32 sum, and the cut back to each
    leaf's shape and dtype: the JAX package's op sequence.  ``dcn_reduce``
    (a ``shard -> summed shard`` callable) replaces the ``dcn`` all-reduce:
    the quantized ring of ``Hierarchical(dcn_compress=...)``."""
    flat = _flat(grads, torch.float32)
    total = flat.numel()
    n_ici = _size(ici)
    padded = F.pad(flat, (0, (-total) % n_ici))
    shard = torch.empty(padded.numel() // n_ici, dtype=padded.dtype,
                        device=padded.device)
    reduce_scatter_flat(shard, padded, group=ici)
    if dcn is not None:
        if dcn_reduce is not None:
            shard = dcn_reduce(shard)
        else:
            dist.all_reduce(shard, group=dcn)
    full = torch.empty_like(padded)
    all_gather_flat(full, shard, group=ici)
    summed = full[:total]
    if scale is not None:
        summed = summed * scale
    return _split(summed, grads)


class Hierarchical:
    """Two-level gradient mean over a ``("dcn", "ici")`` mesh: reduce-scatter
    over ``ici``, a shard-sized all-reduce over ``dcn``, all-gather over
    ``ici`` (``two_level_psum``), the f32 sum scaled by ``1/n``: the exact
    global mean, with |grads|/ici bytes across the slow link.  The trainer
    builds the mesh from ``TrainConfig.dcn_size``.

    ``dcn_compress="int8"`` (or ``"int4"``) quantizes the slow hop alone:
    the shard exchange over ``dcn`` is ``QuantizedRing._ring_sum`` at that
    width, one ring a ``make_bucket_plan`` bucket, and every bit the wire
    drops lands in this rank's error-feedback residual, which the trainer
    carries to the next step (``quantized_ring_ef``'s carry).  Compression
    makes the strategy stateful; its numerics then depend on the bucket
    layout, which the overlapped and post-backward paths share."""

    name = "hierarchical"
    needs_mesh = True
    axes = ("dcn", "ici")  # outer = cross-slice (slow), inner = within
    supports_overlap = True

    def __init__(self, dcn_compress: str | None = None, dcn_size: int = 2,
                 bucket_mb: float = BUCKET_CAP_MB):
        self.bucket_bytes = int(bucket_mb * 1024 * 1024)
        self.set_dcn(dcn_compress, dcn_size)

    def set_dcn(self, compress: str | None, dcn_size: int) -> None:
        """The slow-hop knobs (the trainers set them from ``dcn_compress``
        and ``dcn_size`` before the step and the sync state are built: the
        residual's layout reads ``dcn_size``)."""
        if compress not in (None, "int8", "int4"):
            raise ValueError(f"dcn_compress must be None, 'int8', or "
                             f"'int4', got {compress!r}")
        self.dcn_compress = compress
        self.dcn_size = dcn_size
        # the ring's chunk layout does not depend on its width, so the
        # residual's length is the same at int8 and int4
        self._ring = QuantizedRing(bits=4 if compress == "int4" else 8)
        self.stateful = compress is not None

    # -- the residual's layout (dcn_compress only) -------------------------
    @staticmethod
    def _shard_len(total: int, n_ici: int) -> int:
        """One rank's ``ici`` shard of a ``total``-element bucket (the
        reduce-scatter pads to a multiple of ``n_ici``)."""
        return -(-total // n_ici)

    def _segments(self, leaves: list, n_dcn: int, n_ici: int) -> list[int]:
        return [n_dcn * self._ring._chunk(
                    self._shard_len(sum(_numel(leaves[i]) for i in b),
                                    n_ici), n_dcn)
                for b in make_bucket_plan(leaves, self.bucket_bytes)]

    def state_segments(self, leaves: list, n_axis: int) -> list[int]:
        """Per-bucket residual lengths (n_dcn x the dcn ring's chunk of the
        ``ici`` shard), in bucket-plan order."""
        return self._segments(leaves, self.dcn_size, n_axis // self.dcn_size)

    def init_state(self, leaves: list, n_axis: int,
                   device: str | torch.device = "cpu") -> torch.Tensor:
        """This rank's zero residual (empty without compression)."""
        n = sum(self.state_segments(leaves, n_axis)) \
            if self.dcn_compress is not None else 0
        return torch.zeros(n, dtype=torch.float32, device=device)

    def sync_bucket(self, leaves: list, axis,
                    residual: torch.Tensor | None = None):
        """One two-level reduction over this bucket; compressed, also the
        bucket's residual segment in and its new one out."""
        dcn, ici = factor_groups(axis)
        n_dcn = _size(dcn) if dcn is not None else 1
        n = _size(ici) * n_dcn
        if self.dcn_compress is None:
            return two_level_psum(leaves, dcn, ici, scale=1.0 / n)
        out: dict = {}
        synced = two_level_psum(
            leaves, dcn, ici, scale=1.0 / n,
            dcn_reduce=ring_reduce(self._ring, dcn, n_dcn, residual, out))
        if dcn is None:  # one level: no hop ran, nothing was dropped
            out["res"] = torch.zeros_like(residual)
        return synced, out["res"]

    def __call__(self, grads: list, axis,
                 sync_state: torch.Tensor | None = None):
        dcn, ici = factor_groups(axis)
        if self.dcn_compress is None:
            n = _size(ici) * (_size(dcn) if dcn is not None else 1)
            return two_level_psum(grads, dcn, ici, scale=1.0 / n)
        # one ring-exchanged reduction a bucket
        n_dcn = _size(dcn) if dcn is not None else 1
        return sync_segments(
            grads, make_bucket_plan(grads, self.bucket_bytes),
            self._segments(grads, n_dcn, _size(ici)),
            lambda j, vals, seg: self.sync_bucket(vals, axis, seg),
            sync_state)


    # -- the sync windows (sync_every > 1) --------------------------------
    # A window's local steps run ``local_sync`` (the within-slice mean:
    # the per-step path's ici hops, no dcn hop) and its boundary runs
    # ``window_exchange`` on the accumulated update delta (the slow hop,
    # shard-sized, once a window).

    def local_sync(self, grads: list, axis) -> list:
        """The within-slice gradient mean of a window's local step: the
        reduce-scatter and all-gather over ``ici`` with no ``dcn`` hop,
        scaled by ``1/n_ici``.  Never compressed (compression is the dcn
        hop's knob), so stateless whatever ``dcn_compress`` is."""
        _, ici = factor_groups(axis)
        return two_level_psum(grads, None, ici, scale=1.0 / _size(ici))

    def window_exchange(self, delta: list, axis,
                        sync_state: torch.Tensor | None = None):
        """The cross-slice mean of a window's accumulated update ``delta``,
        equal within a slice after its ``local_sync`` steps: per bucket,
        each rank takes its own ``ici``-indexed chunk of the padded flat
        bucket (no reduce-scatter: the slice's ranks hold the same
        values), exchanges it over ``dcn`` (an all-reduce, or under
        ``dcn_compress`` the int8/int4 ring with the residual, in the
        per-step path's segment layout), all-gathers over ``ici`` and
        scales by ``1/n_dcn``.  The JAX package runs these three hops
        through its route executor; the port issues them directly.
        Compressed, returns ``(mean, new residual)``."""
        dcn, ici = factor_groups(axis)
        n_dcn = _size(dcn) if dcn is not None else 1
        n_ici, me = _size(ici), dist.get_rank(ici)
        compress = self.dcn_compress is not None

        def sync_fn(j, leaves, residual):
            flat = _flat(leaves, torch.float32)
            total = flat.numel()
            padded = F.pad(flat, (0, (-total) % n_ici))
            chunk = padded.numel() // n_ici
            shard = padded[me * chunk:(me + 1) * chunk].clone()
            out: dict = {}
            if compress and dcn is not None:
                shard = ring_reduce(self._ring, dcn, n_dcn, residual,
                                    out)(shard)
            elif compress:  # one level: nothing crosses, nothing is lost
                out["res"] = torch.zeros_like(residual)
            elif dcn is not None:
                dist.all_reduce(shard, group=dcn)
            full = torch.empty_like(padded)
            all_gather_flat(full, shard, group=ici)
            return _split(full[:total] * (1.0 / n_dcn), leaves), \
                out.get("res", residual)

        segs = self._segments(delta, n_dcn, n_ici) if compress else \
            [0] * len(make_bucket_plan(delta, self.bucket_bytes))
        if sync_state is None:
            sync_state = torch.zeros(0, dtype=torch.float32,
                                     device=delta[0].device)
        synced, new = sync_segments(
            delta, make_bucket_plan(delta, self.bucket_bytes), segs,
            sync_fn, sync_state)
        return (synced, new) if compress else synced


class OuterOptimizer:
    """The DiLoCo outer optimizer of a window boundary: ``anchor <- anchor
    + lr * step``, ``step`` Nesterov (``mu * m' + d``) or heavy-ball
    (``m'``) momentum over the exchanged mean delta ``d`` (``m' = mu * m +
    d``).  Momentum is float32, anchor-shaped; the arithmetic is float32
    and the result is cast back to each leaf's dtype.  Each multiply-add
    is taken in float64 and rounded once: XLA's CPU backend fuses the JAX
    package's ``mu * m + d`` and ``a + lr * s`` into fused multiply-adds,
    whose single rounding this reproduces.

    ``trivial`` (momentum 0 and lr 1) is the plain mean: ``apply`` then
    adds ``d`` and keeps no state, and the trainers build no momentum, so
    a trivial outer optimizer is bitwise the plain window."""

    KINDS = ("nesterov", "momentum")

    def __init__(self, kind: str, momentum: float = 0.9, lr: float = 1.0):
        if kind not in self.KINDS:
            raise ValueError(f"outer_opt must be one of {self.KINDS} "
                             f"(or None for the plain mean), got {kind!r}")
        self.kind = kind
        self.momentum = float(momentum)
        self.lr = float(lr)

    @property
    def trivial(self) -> bool:
        """True when the update is ``anchor + d`` exactly."""
        return self.momentum == 0.0 and self.lr == 1.0

    @classmethod
    def of(cls, cfg) -> "OuterOptimizer | None":
        """A trainer config's outer optimizer (``sync_every``,
        ``outer_opt``, ``outer_momentum``, ``outer_lr``), or None for the
        plain mean: without a window or ``outer_opt``, and when trivial,
        so that the plain-mean path runs, bitwise."""
        if cfg.sync_every > 1 and cfg.outer_opt is not None:
            outer = cls(cfg.outer_opt, cfg.outer_momentum, cfg.outer_lr)
            if not outer.trivial:
                return outer
        return None

    # -- tree form: lists of tensors (the LM trainer's anchor-shaped state)
    def init_state(self, anchor: list) -> list:
        """float32 zero momentum, one tensor an anchor leaf."""
        return [torch.zeros(a.shape, dtype=torch.float32, device=a.device)
                for a in anchor]

    @staticmethod
    def _fma(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``a * x + y`` over float32 tensors, rounded once to float32."""
        a32 = float(np.float32(a))
        return (x.double() * a32 + y.double()).float()

    @torch.no_grad()
    def apply(self, anchor: list, d_avg: list, m: list):
        """One outer step: ``(new anchor, new momentum)``, new tensors."""
        if self.trivial:
            return [a + d for a, d in zip(anchor, d_avg)], m
        mu = self.momentum
        m = [self._fma(mu, mi, d.float()) for d, mi in zip(d_avg, m)]
        if self.kind == "nesterov":
            step = [self._fma(mu, mi, d.float()) for d, mi in zip(d_avg, m)]
        else:
            step = m
        anchor = [self._fma(self.lr, s, a.float()).to(a.dtype)
                  for a, s in zip(anchor, step)]
        return anchor, m

    # -- flat form: the VGG trainer's momentum rides its sync state after
    #    the residual segments, raveled in leaf order
    @staticmethod
    def state_len(params: list) -> int:
        return sum(_numel(p) for p in params)

    def init_flat(self, params: list,
                  device: str | torch.device = "cpu") -> torch.Tensor:
        return torch.zeros(self.state_len(params), dtype=torch.float32,
                           device=device)

    def apply_flat(self, anchor: list, d_avg: list, flat_m: torch.Tensor):
        """``apply`` with the momentum one flat float32 vector (each leaf
        raveled in the order and shape it is given)."""
        if self.trivial:
            return [a + d for a, d in zip(anchor, d_avg)], flat_m
        m, offset = [], 0
        for a in anchor:
            m.append(flat_m[offset:offset + a.numel()].view(a.shape))
            offset += a.numel()
        anchor, m = self.apply(anchor, d_avg, m)
        return anchor, torch.cat([t.reshape(-1) for t in m])


_REGISTRY: dict[str, Callable] = {
    "none": NoSync,
    "all_reduce": AllReduce,
    "gather_scatter": GatherScatter,
    "gather_scatter_symmetric": GatherScatterSymmetric,
    "ddp": DDP,
    "bucketed": Bucketed,
    "quantized": QuantizedAllReduce,
    "quantized_ring": QuantizedRing,
    "quantized_ring_ef": QuantizedRingEF,
    "hierarchical": Hierarchical,
}


def get(name: str):
    """A strategy by name."""
    try:
        return _REGISTRY[name]()
    except KeyError:
        if name == "auto":
            raise ValueError(
                "strategy 'auto' must be resolved to a named strategy "
                "first; the registry holds only concrete strategies: "
                f"{sorted(_REGISTRY)}") from None
        raise ValueError(
            f"unknown strategy {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available() -> list[str]:
    return sorted(_REGISTRY)


def overlap_capable() -> list[str]:
    """Strategies usable with ``TrainConfig(overlap=True)``: those with a
    per-bucket ``sync_bucket`` for the sync points to call.  The
    sequential baselines (all_reduce, the gather_scatter pair) keep their
    serialized wire pattern on purpose."""
    return sorted(n for n, c in _REGISTRY.items()
                  if getattr(c, "supports_overlap", False))


def require_overlap_capable(strategy) -> None:
    """Raise unless ``strategy`` can run as in-backward bucket collectives;
    shared by the VGG trainer's config check and ``OverlapSync``."""
    if not getattr(strategy, "supports_overlap", False):
        raise ValueError(
            f"strategy {strategy.name!r} does not support overlap=True; "
            f"overlap-capable strategies: {overlap_capable()} (the "
            f"sequential baselines keep their serialized wire pattern on "
            f"purpose)")


def require_lm_overlap_streamable(*, fsdp: bool, dcn: bool,
                                  pp: bool = False) -> None:
    """The LM trainer's overlap check: raise unless the config has
    something to stream through the layer-group boundaries: the ZeRO-3
    gathers (``fsdp``), the two-level dcn sync points (``dcn``: dcn_size >
    1 with the sync inside the backward, which under grad_accum > 1 it is
    not) or the 1F1B pipeline (``pp``)."""
    if fsdp or dcn or pp:
        return
    raise ValueError(
        "lm overlap=True streams the ZeRO-3 (fsdp) weight gathers and/or "
        "the factored-mesh (dcn_size > 1) two-level sync points through "
        "the layer boundaries; without either there is no post-backward "
        "cluster to dissolve (BASELINE.md rounds 8-9).  Enable fsdp, set "
        "dcn_size > 1, set pp_size > 0, or drop overlap (the VGG "
        "trainer's overlap=True covers the explicit-strategy case)")


def require_sync_window(*, sync_every: int, staleness: int = 0,
                        max_sync_every: int = 1, mesh: bool = True,
                        overlap: bool = False, pp: bool = False,
                        grad_accum: int = 1, dcn_size: int | None = None,
                        steps_per_loop: int | None = None,
                        trainer: str = "train",
                        outer_opt: str | None = None,
                        outer_momentum: float = 0.9,
                        outer_lr: float = 1.0,
                        sync_every_per_slice: tuple | None = None) -> None:
    """The sync windows' coherence check (``TrainConfig(sync_every=H)``
    and ``LMTrainConfig(sync_every=H)``): the one refusal site that both
    trainers' configs and both CLIs call, the JAX package's check with its
    messages word for word.

    Refused: a window without a mesh, with a pipeline, with
    ``grad_accum > 1`` or with the VGG trainer's ``overlap``; an LM window
    without a slow axis (``dcn_size < 2``); staleness outside ``0 <= S <
    H``; ``outer_opt`` without a window or with a momentum outside [0, 1)
    or a non-positive lr; ``sync_every_per_slice`` on the VGG trainer,
    without a window, with staleness, with other than ``dcn_size``
    entries, with an entry not a multiple of the base or with
    ``min != sync_every``; and a VGG ``steps_per_loop`` that does not end
    each call on a boundary."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    if max_sync_every < 1:
        raise ValueError(
            f"max_sync_every must be >= 1, got {max_sync_every}")
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    if sync_every == 1 and staleness > 0:
        raise ValueError(
            f"staleness={staleness} needs sync_every > 1: with per-step "
            f"sync there are no local steps to hide the exchange under")
    if staleness >= sync_every and staleness > 0:
        raise ValueError(
            f"staleness={staleness} >= sync_every={sync_every}: the "
            f"delayed window exchange must land before the next one "
            f"launches (0 <= S < H; S=0 applies at the boundary step)")
    if outer_opt is not None:
        if outer_opt not in OuterOptimizer.KINDS:
            raise ValueError(
                f"outer_opt must be None, 'nesterov', or 'momentum', "
                f"got {outer_opt!r}")
        if sync_every == 1:
            raise ValueError(
                f"outer_opt={outer_opt!r} needs sync_every > 1: the "
                f"outer step applies at window boundaries — with "
                f"per-step sync there is no window delta to apply it to")
        if not 0.0 <= outer_momentum < 1.0:
            raise ValueError(
                f"outer_momentum must sit in [0, 1), got "
                f"{outer_momentum}")
        if outer_lr <= 0.0:
            raise ValueError(f"outer_lr must be > 0, got {outer_lr}")
    if sync_every_per_slice is not None:
        per = tuple(sync_every_per_slice)
        if trainer != "lm":
            raise ValueError(
                "sync_every_per_slice is an LM-trainer (factored 'dcn' "
                "mesh) feature: the VGG trainer's windows are gang-wide "
                "over one flat replica axis — there is no per-slice "
                "boundary program to skip")
        if sync_every == 1:
            raise ValueError(
                "sync_every_per_slice needs the windowed mode "
                "(sync_every > 1): the base interval is the compiled "
                "boundary cadence the per-slice windows subdivide")
        if staleness > 0:
            raise ValueError(
                f"sync_every_per_slice does not compose with "
                f"staleness={staleness}: the skip mask and the deferred "
                f"apply would both reinterpret the same boundary; pick "
                f"one relaxation")
        if dcn_size is not None and len(per) != dcn_size:
            raise ValueError(
                f"sync_every_per_slice has {len(per)} entries but "
                f"dcn_size={dcn_size}: one interval per slice")
        if any(not isinstance(h, int) or h < 1 for h in per):
            raise ValueError(
                f"sync_every_per_slice entries must be ints >= 1, got "
                f"{per}")
        if any(h % sync_every for h in per):
            raise ValueError(
                f"every sync_every_per_slice entry must be a multiple "
                f"of the base sync_every={sync_every} (slices exchange "
                f"only at base boundaries), got {per}")
        if min(per) != sync_every:
            raise ValueError(
                f"min(sync_every_per_slice)={min(per)} must equal the "
                f"base sync_every={sync_every}: the base is the "
                f"tightest slice's cadence — a larger base would mean "
                f"boundaries no compiled program runs")
    if sync_every == 1:
        return
    if not mesh:
        raise ValueError(
            f"sync_every={sync_every} needs a device mesh: the meshless "
            f"single-jit path has no collective exchange to amortize "
            f"(and no per-device window state); use a mesh-backed "
            f"strategy or sync_every=1")
    if pp:
        raise ValueError(
            f"sync_every={sync_every} is incompatible with pipeline "
            f"parallelism (pp_size > 0): the 1F1B schedule has no "
            f"per-step data exchange a window could skip")
    if grad_accum > 1:
        raise ValueError(
            f"sync_every={sync_every} with grad_accum={grad_accum}: "
            f"grad accumulation already amortizes the exchange over its "
            f"micro-steps — composing the two would double-count the "
            f"window; pick one")
    if trainer == "train" and overlap:
        raise ValueError(
            f"sync_every={sync_every} with overlap=True: the in-backward "
            f"markers stream the per-step collective a window removes; "
            f"run windows post-backward (overlap=False)")
    if trainer == "lm" and dcn_size is not None and dcn_size < 2:
        raise ValueError(
            f"sync_every={sync_every} needs dcn_size >= 2 on the LM "
            f"trainer: windows relax the slow DCN hop specifically — "
            f"with a single slice there is no scarce axis to relax")
    if (trainer == "train" and steps_per_loop is not None
            and steps_per_loop % sync_every):
        raise ValueError(
            f"steps_per_loop={steps_per_loop} is not a multiple of "
            f"sync_every={sync_every}: each compiled dispatch must end "
            f"on a window boundary so params leave the step replicated")


# -- backward-overlapped gradient sync ----------------------------------------

class _SyncPoint(torch.autograd.Function):
    """A sync point: ``forward_fn`` maps its tensors to what the model uses
    (None: the tensors as they are, an identity); its backward hands their
    cotangents (each the sum of every use's gradient, as autograd sums them
    before it calls a node's backward) to ``backward_fn``, whose list is
    the inputs' gradients, under the profiler range ``name``."""

    @staticmethod
    def forward(ctx, name, forward_fn, backward_fn, *tensors):
        ctx.name, ctx.backward_fn = name, backward_fn
        if forward_fn is None:
            return tuple(t.view_as(t) for t in tensors)
        return tuple(forward_fn(list(tensors)))

    @staticmethod
    def backward(ctx, *cts):
        with torch.profiler.record_function(ctx.name):
            grads = ctx.backward_fn(list(cts))
        return (None, None, None) + tuple(grads)


def sync_boundary(tree: list, sync_fn: Callable[[list], list],
                  group_id: int | str | None = None) -> list:
    """Identity on the tensors of ``tree`` whose backward applies
    ``sync_fn`` to their cotangents at this point of the backward graph:
    the in-backward bucket collective of overlap mode.  ``group_id`` names
    the layer group whose boundary this is: the backward runs under the
    profiler range ``sync_boundary:<group_id>``."""
    return list(_SyncPoint.apply(f"sync_boundary:{group_id}", None, sync_fn,
                                 *tree))


def sync_boundary_stateful(tree: list, residual: torch.Tensor,
                           sync_fn: Callable, group_id=None, *,
                           out: dict) -> list:
    """``sync_boundary`` for an error-feedback strategy: ``sync_fn(cts,
    residual) -> (synced, new_residual)``.  The JAX package carries the new
    residual out of the backward as the residual's cotangent; here it
    lands in ``out["res"]``.  (Kept for the JAX API's parity: the trainers
    carry their residuals through ``OverlapSync``.)"""
    def backward_fn(cts):
        synced, out["res"] = sync_fn(cts, residual)
        return synced
    return sync_boundary(tree, backward_fn, group_id)


_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    """The side stream the in-backward collectives of ``device`` run on."""
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
    return stream


def _accumulate(p: torch.Tensor, g: torch.Tensor) -> None:
    """``p.grad += g`` as autograd accumulates, ``p.grad`` in ``p``'s
    layout."""
    with torch.no_grad():
        if p.grad is None:
            p.grad = torch.empty_like(p)
            p.grad.copy_(g)
        else:
            p.grad.add_(g)


class _InFlight:
    """The bucket syncs one backward has issued, until the backward ends.

    ``launch(fn, cts, targets)`` runs ``fn(cts)`` (a bucket's sync) and
    accumulates its results into ``targets``' ``.grad`` in a callback
    queued on the autograd engine, which runs once the whole backward is
    done.  On a CUDA device ``fn`` runs on a side stream that first waits
    for the default stream's work so far (the cotangents), so that the
    collective and its elementwise passes run beside the backward kernels
    still to come; the callback makes the default stream wait for the side
    stream before anything reads ``.grad``.  No cotangent is kept past its
    launch (under ZeRO-3 they are the gathered-size gradients, which the
    backward frees one group at a time): each is marked as used by the side
    stream, so that the allocator hands its memory to no later kernel
    before the side stream's work on it is done, and so is each result as
    the default stream reads it.  On the CPU ``fn`` runs inline."""

    def __init__(self):
        self.pending: list = []
        self.queued = False
        self.stream = None

    def launch(self, fn: Callable, cts: list, targets: list) -> None:
        if not self.queued:
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)
            self.queued = True
        dev = cts[0].device
        if dev.type == "cuda":
            self.stream = _side_stream(dev)
            self.stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self.stream):
                result = fn(cts)
            for c in cts:
                c.record_stream(self.stream)
        else:
            result = fn(cts)
        self.pending.append((targets, result))

    def _finish(self) -> None:
        current = None
        if self.stream is not None:
            current = torch.cuda.current_stream(self.stream.device)
            current.wait_stream(self.stream)
        for targets, result in self.pending:
            for p, g in zip(targets, result):
                _accumulate(p, g)
                if current is not None:
                    g.record_stream(current)
        self.pending, self.queued = [], False


def _axis_size(axis) -> int:
    """Ranks over ``axis``: a mesh, a process group or a (dcn, ici) pair."""
    if isinstance(axis, DeviceMesh):
        return axis.size()
    if isinstance(axis, tuple):
        return int(np.prod([_size(a) for a in axis if a is not None]))
    return _size(axis)


def _leaf_group(key: str, group_index: dict) -> int:
    """A leaf's layer group, from its top-level parameter key (models expose
    ``sync_group_index``)."""
    try:
        return group_index[key]
    except KeyError:
        raise ValueError(
            f"param key {key!r} missing from the model's sync_group_index "
            f"map; overlap needs every top-level param entry assigned to a "
            f"forward layer group") from None


class OverlapSync:
    """One step's backward-overlapped gradient sync.

    Packs the leaves, in the JAX tree order (sorted keys, as the
    trainer's ``jax_order``), into ``make_bucket_plan``'s buckets, the
    plan the bucketed and ring strategies use after the backward, so that
    the two paths run the same collectives on the same flat vectors; each
    bucket gets one sync point at its earliest layer-group boundary, where
    every cotangent it needs is complete in the backward.  Usage, fresh
    each step:

        ov = OverlapSync(strategy, mesh, params, vgg.sync_group_index(name),
                         sync_state=residual_or_None)
        logits, state = vgg.apply(params, ..., boundary=ov.boundary)
        loss.backward()             # .grad holds the synced gradients
        residual = ov.new_state()   # stateful strategies

    The model calls ``params = boundary(group, params)`` at each layer-group
    boundary in forward order.  ``layout`` is a pair of callables that take
    a cotangent to the layout the strategy syncs (the rings': the JAX
    package's) and back.  ``tap`` (a fault plan firing this step,
    utils/faults.py ``grad_tap``) poisons its leaf's cotangent before that
    leaf's bucket is launched, as the post-backward path poisons it before
    the sync."""

    def __init__(self, strategy, axis, params: dict, group_index: dict, *,
                 sync_state: torch.Tensor | None = None, layout=None,
                 tap=None):
        require_overlap_capable(strategy)
        self.strategy, self.axis = strategy, axis
        self.order = [(k, n) for k in sorted(params)
                      for n in sorted(params[k])]
        self.leaves = [params[k][n] for k, n in self.order]
        groups = [_leaf_group(k, group_index) for k, _ in self.order]
        self.plan = make_bucket_plan(self.leaves, strategy.bucket_bytes)
        self.to_wire, self.from_wire = layout or (None, None)
        self.stateful = getattr(strategy, "stateful", False)
        if self.stateful:
            if sync_state is None:
                raise ValueError(
                    f"stateful strategy {strategy.name!r} needs sync_state "
                    f"for overlap (the per-rank EF residual)")
            segs = strategy.state_segments(self.leaves, _axis_size(axis))
            offs = np.cumsum([0] + segs).tolist()
            self._res = [sync_state[a:b] for a, b in zip(offs, offs[1:])]
            self._new_res: list = [None] * len(self.plan)
        # bucket b fires at its earliest forward group's boundary: by then
        # every later group's backward, hence every cotangent it needs, is
        # complete
        self._due: dict[int, list[int]] = {}
        for b, bucket in enumerate(self.plan):
            self._due.setdefault(min(groups[i] for i in bucket), []).append(b)
        self._marked: set[int] = set()
        self._inflight = _InFlight()
        self._tap = tap
        self._tap_leaf = (faults.tap_index(tap, len(self.leaves))
                          if tap is not None else None)

    def boundary(self, group: int, params: dict) -> dict:
        """``params`` with the leaves of the buckets due at this boundary
        replaced by their sync points' outputs (a new dict)."""
        due = self._due.get(group)
        if not due:
            return params
        out = {k: dict(v) for k, v in params.items()}
        for b in due:
            assert b not in self._marked, (b, group)
            self._marked.add(b)
            bucket = self.plan[b]
            sub = [out[k][n] for k, n in (self.order[i] for i in bucket)]
            targets = [self.leaves[i] for i in bucket]

            def backward_fn(cts, b=b, targets=targets, bucket=bucket):
                if self._tap_leaf in bucket:
                    cts = list(cts)
                    j = bucket.index(self._tap_leaf)
                    cts[j] = faults.poison(self._tap, cts[j])
                self._inflight.launch(partial(self._sync, b), cts, targets)
                return [None] * len(cts)

            for i, m in zip(bucket, sync_boundary(sub, backward_fn, group)):
                k, n = self.order[i]
                out[k][n] = m
        return out

    def _sync(self, b: int, cts: list) -> list:
        given = [self.to_wire(c) for c in cts] if self.to_wire else cts
        if self.stateful:
            synced, self._new_res[b] = self.strategy.sync_bucket(
                given, self.axis, self._res[b])
        else:
            synced = self.strategy.sync_bucket(given, self.axis)
        return [self.from_wire(s) for s in synced] if self.from_wire \
            else synced

    def new_state(self) -> torch.Tensor:
        """The stateful strategy's new residual, after the backward."""
        if len(self._marked) != len(self.plan):
            raise RuntimeError(
                f"only {len(self._marked)} of {len(self.plan)} buckets met "
                f"their layer-group boundary in the forward")
        return torch.cat(self._new_res)
