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
                    over ``ici``, the f32 sum scaled by ``1/n``.

The strategies that pack leaves into one flat vector (``make_bucket_plan``,
``bucketed``, the rings, ``hierarchical``) concatenate them in the order
given.  The trainer hands every strategy its leaves in the JAX package's
tree order (sorted keys), and the rings each leaf in the JAX layout (conv
kernels HWIO), so that a ring's block scales group the same values as the
JAX ring's.  A division by a constant (the mean's ``n``, the quantization
levels 127 and 7) is a multiplication by its float32 reciprocal, as XLA
compiles the JAX strategies' ``/ n`` and ``/ levels``.  A strategy may
overwrite the tensors it is given; it returns the synced list.

The overlapped sync (``OverlapSync``, the sync boundaries), local-SGD
windows, the DiLoCo outer optimizer and ``dcn_compress`` belong to slice
5b; ``RoutedSync``, ``auto`` and ``routed`` to slice 5f.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..models.transformer import SYNC_SLICE, not_ported

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

    def __call__(self, grads: list, axis) -> list:
        return self.sync_bucket(grads, axis)


class QuantizedAllReduce:
    """Int8-quantized all-reduce: per tensor a symmetric int8 quantization
    against a scale shared through ``all_reduce(MAX)`` of max|g|, the int8
    values summed exactly as int32, dequantized, ``/ n``.  Two collectives
    a tensor; int32 on the wire, as in the JAX strategy."""

    name = "quantized"
    needs_mesh = True

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
        out: list = [None] * len(grads)
        new_parts, offset = [], 0
        for bucket, seg in zip(self._plan(grads),
                               self.state_segments(grads, n)):
            synced, new_r = self.sync_bucket(
                [grads[i] for i in bucket], axis,
                residual[offset:offset + seg])
            offset += seg
            new_parts.append(new_r)
            for i, s in zip(bucket, synced):
                out[i] = s
        return out, torch.cat(new_parts)


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


def two_level_psum(grads: list, dcn, ici, scale: float | None = None
                   ) -> list:
    """The two-level reduction under ``Hierarchical``: the leaves as one
    f32 vector padded to a multiple of the ``ici`` size, a reduce-scatter
    over ``ici``, a shard-sized all-reduce over ``dcn`` (the only
    cross-slice traffic), an all-gather over ``ici``, the slice back to the
    true length, ``scale`` applied to the f32 sum, and the cut back to each
    leaf's shape and dtype: the JAX package's op sequence."""
    flat = _flat(grads, torch.float32)
    total = flat.numel()
    n_ici = _size(ici)
    padded = F.pad(flat, (0, (-total) % n_ici))
    shard = torch.empty(padded.numel() // n_ici, dtype=padded.dtype,
                        device=padded.device)
    reduce_scatter_flat(shard, padded, group=ici)
    if dcn is not None:
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
    builds the mesh from ``TrainConfig.dcn_size``.  ``dcn_compress`` (the
    quantized slow hop and its residual) belongs to slice 5b."""

    name = "hierarchical"
    needs_mesh = True
    axes = ("dcn", "ici")  # outer = cross-slice (slow), inner = within

    def __init__(self, dcn_compress: str | None = None, dcn_size: int = 2):
        self.set_dcn(dcn_compress, dcn_size)

    def set_dcn(self, compress: str | None, dcn_size: int) -> None:
        if compress not in (None, "int8", "int4"):
            raise ValueError(f"dcn_compress must be None, 'int8', or "
                             f"'int4', got {compress!r}")
        if compress is not None:
            raise not_ported(f"Hierarchical dcn_compress={compress!r} "
                             f"(the quantized dcn hop)", SYNC_SLICE)
        self.dcn_compress = compress
        self.dcn_size = dcn_size
        self.stateful = False

    def __call__(self, grads: list, axis) -> list:
        dcn, ici = factor_groups(axis)
        n = _size(ici) * (_size(dcn) if dcn is not None else 1)
        return two_level_psum(grads, dcn, ici, scale=1.0 / n)


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
