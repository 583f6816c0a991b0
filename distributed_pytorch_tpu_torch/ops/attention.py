"""Attention ops: plain PyTorch reference attention, flash attention and the
decode-attention kernel (the port of the JAX package's ops/attention.py).

- ``attention_reference``: einsum -> float32 softmax -> einsum over
  (B, H, S, D); the oracle, and the prefill attention of generate.py.
- ``flash_attention``: tiled attention with a custom backward (a
  ``torch.autograd.Function``), optionally returning the row logsumexp as
  a second differentiable output.  On CUDA tensors the forward launches
  the hand-written kernel K2 and the backward K3 (dQ) and K4 (dK, dV) of
  csrc/flash_attention.cu; on CPU tensors the same autograd.Function runs
  ``flash_attention_fwd_plain`` and ``flash_attention_bwd_plain``.
- ``decode_attention``: single-token decode over a contiguous KV cache with
  exact ``pos+1`` read bounds.  On a CUDA tensor it launches the
  hand-written kernel in csrc/decode_attention.cu (TPU kernels K6 and K7);
  on a CPU tensor it runs ``decode_attention_plain``, the same function in
  plain PyTorch.
- ``decode_attention_paged``: the same decode over a PAGED KV pool, each
  sequence's cache blocks looked up in a block table.  On a CUDA tensor it
  launches the paged instance of the same kernel (TPU kernels K8 and K9);
  on a CPU tensor it runs ``decode_attention_paged_plain``.
There is no fallback from a kernel to its plain version: a CUDA input a
kernel does not take raises.

Shapes follow the (batch, heads, seq, head_dim) convention.
"""

from __future__ import annotations

import ctypes
import math

import torch

# The JAX package's flash-attention block defaults.  The CUDA kernels tile
# by their own sizes; these only decide which sequence lengths are refused
# (``_fit_block``), so both packages take the same arguments.
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024
# Decode reads are skipped at tile granularity in the JAX package's kernel;
# kept as the block the plain path's callers size caches against.
DEFAULT_DECODE_BLOCK_K = 256
NEG_INF = -1e30  # large-negative instead of -inf: keeps exp()/max() NaN-free

# What the CUDA kernels take (csrc/decode_attention.cu and, for head dims
# and dtypes, csrc/flash_attention.cu).
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_GROUP = 16
_QTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _scores(q, k, causal: bool, sm_scale: float, bias=None) -> torch.Tensor:
    """float32 (..., Sq, Sk) scaled scores plus ``bias``, NEG_INF where
    causally masked (query i sees keys j <= i + Sk - Sq)."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        qi = torch.arange(sq, device=s.device)[:, None]
        kj = torch.arange(sk, device=s.device)[None, :]
        s = torch.where(qi + (sk - sq) >= kj, s,
                        torch.full((), NEG_INF, device=s.device))
    return s


def attention_reference(q, k, v, *, causal: bool = False,
                        sm_scale: float | None = None, with_lse: bool = False,
                        bias: torch.Tensor | None = None):
    """Plain attention over (B, H, S, D) tensors (any leading dims).

    Scores and softmax in float32 regardless of input dtype; ``p`` is cast
    to ``v``'s dtype before the P.V product, which accumulates in float32.
    ``bias`` is an additive score bias broadcastable to (B, H, Sq, Sk).
    With ``with_lse`` also returns the row logsumexp (B, H, Sq)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal, sm_scale, bias)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("...qk,...kd->...qd", p.to(v.dtype).float(),
                     v.float()).to(q.dtype)
    if with_lse:
        return o, lse
    return o


def _fit_block(limit: int, s: int) -> int:
    """Largest 8-aligned divisor of ``s`` that is <= ``limit``; a block
    below 128 is accepted only when it is the whole sequence."""
    for b in range(min(limit, s), 7, -1):
        if s % b == 0 and b % 8 == 0 and (b >= 128 or b == s):
            return b
    raise ValueError(
        f"sequence length {s} has no MXU-friendly divisor <= {limit} "
        f"(need an 8-aligned divisor >= 128, or s itself); pad the "
        f"sequence or pass explicit block sizes")


# -- flash attention: plain versions ---------------------------------------

def flash_attention_fwd_plain(q, k, v, *, causal: bool = False,
                              sm_scale: float | None = None):
    """Plain-PyTorch forward of flash attention over (..., S, D) operands:
    ``(o, lse)``, ``attention_reference(with_lse=True)`` itself (float32
    scores and softmax, ``p`` cast to ``v``'s dtype before P.V, o in
    ``q``'s dtype, lse float32)."""
    return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                               with_lse=True)


def flash_attention_bwd_plain(q, k, v, lse, do, delta, *,
                              causal: bool = False,
                              sm_scale: float | None = None):
    """Plain-PyTorch backward of flash attention, the K3/K4 formulas:
    ``p = exp(s - lse)`` recomputed from q, k and the saved lse;
    ``dp = do . v`` (do cast to v's dtype); ``ds = p (dp - delta) scale``;
    ``dq = ds . k``, ``dk = ds^T . q``, ``dv = p^T . do`` with ds and p cast
    to the other operand's dtype first and float32 sums.  ``delta`` is
    rowsum(do * o) - dlse in float32 (..., Sq).  Returns (dq, dk, dv)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse.float()[..., None])
    dp = torch.einsum("...qd,...kd->...qk", do.to(v.dtype).float(), v.float())
    ds = p * (dp - delta.float()[..., None]) * sm_scale
    dq = torch.einsum("...qk,...kd->...qd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("...qk,...qd->...kd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("...qk,...qd->...kd", p.to(do.dtype).float(),
                      do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- flash attention: the CUDA kernels (K2, K3, K4) ------------------------

def _check_flash(name: str, q, k, v, *rest) -> tuple[int, int, int, int]:
    """(BH, Sq, Sk, D) of the kernel operands, or ValueError for what the
    kernel does not take.  ``rest`` are do (q's shape) then float32 (BH, Sq)
    lse and delta."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"{name}: kernel operands are (B*H, S, D), got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if q.dtype not in _QTYPES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if k.shape != (bh, sk, d) or v.shape != (bh, sk, d):
        raise ValueError(f"{name}: k/v shapes {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if bh > 65535 or sq < 1 or sk < 1:
        raise ValueError(f"{name}: the kernel takes 1 <= S and B*H <= 65535, "
                         f"got {tuple(q.shape)}")
    tensors = [(q, q.dtype), (k, q.dtype), (v, q.dtype)]
    if rest:
        do, lse, delta = rest
        if do.shape != q.shape or lse.shape != (bh, sq) \
                or delta.shape != (bh, sq):
            raise ValueError(f"{name}: do {tuple(do.shape)}, lse "
                             f"{tuple(lse.shape)} and delta "
                             f"{tuple(delta.shape)} do not match q "
                             f"{tuple(q.shape)}")
        tensors += [(do, q.dtype), (lse, torch.float32),
                    (delta, torch.float32)]
    for t, dtype in tensors:
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} operands, got "
                             f"{t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be a contiguous "
                             f"tensor on q's device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    return bh, sq, sk, d


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _flash_launch(entry: str, q: torch.Tensor, *args) -> None:
    """Call ``entry`` of csrc/flash_attention.cu with ``args`` on q's
    current stream; raise on the CUDA error it returns."""
    from ._build import load_library
    lib = load_library("flash_attention")
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    err = getattr(lib, entry)(*args, stream)
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({lib.flash_attention_error(err).decode()})")


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        sm_scale: float | None = None):
    """Flash-attention forward over (B*H, S, D): ``(o, lse)``.

    On CUDA tensors this launches K2 on the current stream and adds one to
    ``flash_attention_fwd.launches``; on CPU tensors it runs
    ``flash_attention_fwd_plain`` (no launch is counted)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
    bh, sq, sk, d = _check_flash("flash_attention_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _flash_launch("flash_fwd_launch", q, _QTYPES[q.dtype], d, _ptr(q),
                  _ptr(k), _ptr(v), _ptr(o), _ptr(lse), bh, sq, sk,
                  int(causal), ctypes.c_float(sm_scale))
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd_dq(q, k, v, lse, do, delta, *, causal: bool = False,
                           sm_scale: float | None = None):
    """dQ of flash attention over (B*H, S, D).  On CUDA tensors this
    launches K3 and adds one to ``flash_attention_bwd_dq.launches``; on CPU
    tensors it runs ``flash_attention_bwd_plain``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, lse, do, delta,
                                         causal=causal, sm_scale=sm_scale)[0]
    bh, sq, sk, d = _check_flash("flash_attention_bwd_dq", q, k, v, do, lse,
                                 delta)
    dq = torch.empty_like(q)
    _flash_launch("flash_bwd_dq_launch", q, _QTYPES[q.dtype], d, _ptr(q),
                  _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
                  _ptr(dq), bh, sq, sk, int(causal), ctypes.c_float(sm_scale))
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, lse, do, delta, *, causal: bool = False,
                            sm_scale: float | None = None):
    """(dK, dV) of flash attention over (B*H, S, D).  On CUDA tensors this
    launches K4 and adds one to ``flash_attention_bwd_dkv.launches``; on
    CPU tensors it runs ``flash_attention_bwd_plain``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, lse, do, delta,
                                         causal=causal, sm_scale=sm_scale)[1:]
    bh, sq, sk, d = _check_flash("flash_attention_bwd_dkv", q, k, v, do, lse,
                                 delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _flash_launch("flash_bwd_dkv_launch", q, _QTYPES[q.dtype], d, _ptr(q),
                  _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
                  _ptr(dk), _ptr(dv), bh, sq, sk, int(causal),
                  ctypes.c_float(sm_scale))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) (B*H, S, D) -> (o, lse), both differentiable; the port of
    the JAX package's ``_flash_lse`` custom VJP.  The backward folds the lse
    cotangent into ``delta = rowsum(do * o) - dlse`` (float32, outside the
    kernels, as the JAX ``_bwd`` does), then runs dQ and dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, saved):
        if saved:  # a recompute: the first forward's (o, lse), kept
            o, lse = saved
        else:
            o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
            if saved is not None:
                saved.extend((o, lse))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.set_materialize_grads(False)
        if saved is not None:  # outputs apart from the kept tensors
            return o.view_as(o), lse.view_as(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.float()
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        dq = flash_attention_bwd_dq(q, k, v, lse, do, delta, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, lse, do, delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: float | None = None, block_q: int | None = None,
                    block_k: int | None = None, with_lse: bool = False,
                    saved: list | None = None):
    """Tiled attention over (B, H, S, D), differentiable.

    With ``with_lse`` also returns the float32 row logsumexp (B, H, S) as a
    second differentiable output (its cotangent is handled exactly in the
    backward).  The argument checks are the JAX package's: rank 4, causal
    needs sq == sk, and each sequence length must have an 8-aligned divisor
    >= 128 (or be that divisor itself) below the default block, or divide
    the explicitly passed block.  The blocks decide only what is refused:
    the CUDA kernels use their own tiles.  On CUDA tensors the forward
    launches K2 and the backward K3 and K4; on CPU tensors the plain
    versions run through the same autograd.Function.

    ``saved`` keeps the forward's ``(o, lse)`` across a rematerialized
    forward (``apply(remat="selective")``, the JAX package's
    ``attn_out``/``attn_lse`` checkpoint names): an empty list is filled by
    the forward, and a filled one is returned as the output without running
    the forward again, so the recompute launches no K2."""
    if q.ndim != 4:
        raise ValueError(f"expected (B, H, S, D) q, got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    block_q = _fit_block(DEFAULT_BLOCK_Q, sq) if block_q is None else min(
        block_q, sq)
    block_k = _fit_block(DEFAULT_BLOCK_K, sk) if block_k is None else min(
        block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"seq lens ({sq}, {sk}) must divide block sizes "
                         f"({block_q}, {block_k})")
    if causal and sq != sk:
        raise ValueError("causal flash attention requires sq == sk")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    o, lse = _FlashAttention.apply(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, sk, d).contiguous(),
        v.reshape(b * h, sk, d).contiguous(), causal, sm_scale, saved)
    o = o.reshape(b, h, sq, d)
    if with_lse:
        return o, lse.reshape(b, h, sq)
    return o


def _check_decode_args(q, k_cache, k_scale, v_scale):
    b, h, sq, d = q.shape
    if sq != 1:
        raise ValueError(f"decode_attention takes single-token queries, "
                         f"got sq={sq}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    hkv = k_cache.shape[1]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    return b, h, hkv, k_cache.shape[2], d


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, device=device).to(torch.int32)
    return torch.broadcast_to(pos.reshape(-1), (b,)).contiguous()


def decode_attention_plain(q, k_cache, v_cache, pos, *, k_scale=None,
                           v_scale=None, sm_scale: float | None = None):
    """Plain-PyTorch decode attention, the same function as the kernel.

    ``q`` (B, H, 1, D); caches (B, Hkv, S, D); ``pos`` a scalar or (B,):
    sequence ``b`` attends slots ``[0, pos[b]]``.  Query head ``h`` reads
    kv head ``h // (H / Hkv)``.  With ``k_scale``/``v_scale`` (B, Hkv, S,
    1) float32 the caches are int8 and each row dequantizes as (int8 ->
    f32) x scale, cast to ``q``'s dtype.  Returns (B, H, 1, D)."""
    b, h, hkv, s, d = _check_decode_args(q, k_cache, k_scale, v_scale)
    g = h // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    pos_v = _pos_vector(pos, b, q.device)
    k, v = k_cache, v_cache
    if k_scale is not None:
        k = (k.float() * k_scale).to(q.dtype)
        v = (v.float() * v_scale).to(q.dtype)
    qg = q.reshape(b, hkv, g, d).float()
    sc = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * sm_scale
    slot = torch.arange(s, device=q.device)
    live = (slot[None, :] <= pos_v[:, None].long())[:, None, None, :]
    sc = torch.where(live, sc, torch.full((), NEG_INF, device=q.device))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    l_sum = p.sum(-1, keepdim=True)
    acc = torch.einsum("bkgs,bksd->bkgd", p.to(v.dtype).float(), v.float())
    o = acc / torch.clamp(l_sum, min=1e-30)
    return o.to(q.dtype).reshape(b, h, 1, d)


def decode_attention(q, k_cache, v_cache, pos, *, k_scale=None, v_scale=None,
                     sm_scale: float | None = None):
    """Single-token decode attention with exact ``pos+1`` cache-read bounds
    (semantics of ``decode_attention_plain``).

    On CUDA tensors this launches the decode kernel (K6; K7 when the int8
    scales are given) on the current stream and adds one to
    ``decode_attention.launches``.  The kernel takes q and caches in
    float32 or bfloat16 (the same dtype), or an int8 cache with float32
    scales; head_dim 64 or 128; 1 to 16 query heads per kv head; any cache
    length.  Anything else on CUDA raises.  On CPU tensors the plain
    version runs (no launch is counted)."""
    b, h, hkv, s, d = _check_decode_args(q, k_cache, k_scale, v_scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos,
                                      k_scale=k_scale, v_scale=v_scale,
                                      sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    quant = k_scale is not None
    g = h // hkv
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if g > KERNEL_MAX_GROUP:
        raise ValueError(f"decode kernel takes at most {KERNEL_MAX_GROUP} "
                         f"query heads per kv head, got {g}")
    if q.dtype not in _QTYPES:
        raise ValueError(f"decode kernel takes float32 or bfloat16 q, got "
                         f"{q.dtype}")
    want = torch.int8 if quant else q.dtype
    if k_cache.dtype != want or v_cache.dtype != want:
        raise ValueError(f"decode kernel: caches must be {want} for q "
                         f"{q.dtype}, got {k_cache.dtype}/{v_cache.dtype}")
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != d:
        raise ValueError(f"decode kernel: cache shapes {tuple(k_cache.shape)}"
                         f"/{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    tensors = [q, k_cache, v_cache]
    if quant:
        if (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or k_scale.shape != (b, hkv, s, 1)
                or v_scale.shape != (b, hkv, s, 1)):
            raise ValueError("decode kernel: scales must be float32 "
                             f"(B, Hkv, S, 1) = {(b, hkv, s, 1)}")
        tensors += [k_scale, v_scale]
    _check_decode_operands("decode kernel", q, tensors)
    pos_v = _pos_vector(pos, b, q.device)
    out = torch.empty_like(q)
    _decode_launch("decode_attention_launch", q, k_cache, v_cache, k_scale,
                   v_scale, pos_v, out, (b, h, hkv, s), s, sm_scale)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _check_decode_operands(name: str, q, tensors) -> None:
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be a contiguous "
                             f"tensor on q's device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


# Query heads one block of the decode kernel holds when g > 1 (kHeadGroup in
# csrc/decode_attention.cu); at g = 1 a block holds one.
KERNEL_HEAD_GROUP = 4
# The kernel splits every sequence into splits of L slots; L grows with
# the (sequence, kv head, head group) units a split index covers: one
# 32-key tile per DECODE_SPLIT_UNITS units, rounded down to a power of two,
# between 1 and DECODE_MAX_SPLIT_TILES tiles (LM-base serving: 8 slots x 8
# kv heads -> L = 256).
DECODE_SPLIT_UNITS = 8
DECODE_MAX_SPLIT_TILES = 64


def decode_split_plan(b: int, hkv: int, g: int,
                      capacity: int) -> tuple[int, int, int, int]:
    """The decode kernel's split of each (sequence, kv head) row: (L, the
    number of splits, head groups, query heads per group).  Split i covers
    logical slots [i*L, (i+1)*L); a launch has ceil(capacity / L) of them
    (capacity = S dense, page * n_pages paged) and only those that start at
    or before pos[b] do any work.  The plan reads no ``pos``: it depends on
    host-known sizes only, and L on B * Hkv * head groups only, so the
    dense and paged instances split alike."""
    group = 1 if g == 1 else KERNEL_HEAD_GROUP
    n_groups = -(-g // group)
    want = min(b * hkv * n_groups // DECODE_SPLIT_UNITS,
               DECODE_MAX_SPLIT_TILES)
    tiles = 1
    while tiles * 2 <= want:
        tiles *= 2
    split_len = tiles * KERNEL_PAGE_MULTIPLE
    return split_len, -(-capacity // split_len), n_groups, group


# (device, stream) -> (workspace, arrival counters) of the decode kernel's
# in-launch merge: float32 partials that every launch overwrites before it
# reads them, and int32 counters that every launch leaves at 0.  Launches
# on one stream run in turn, so they may share a pair; launches on two
# streams may overlap, so each stream has its own.  Grown, never shrunk;
# nothing is cleared per call.
_DECODE_WORKSPACE: dict = {}


def _decode_workspace(device, stream: int, n_floats: int, n_counters: int):
    key = (device, stream)
    ws, counters = _DECODE_WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(n_floats, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    _DECODE_WORKSPACE[key] = (ws, counters)
    return ws, counters


def _decode_launch(entry: str, q, k, v, k_scale, v_scale, pos_v, out,
                   dims: tuple[int, ...], capacity: int, sm_scale: float,
                   table=None) -> None:
    """Call ``entry`` of csrc/decode_attention.cu as (qtype, ctype, D, q,
    k, v, ks, vs, pos, [table,] out, ws, counters, *dims, L, sm_scale,
    stream) on q's current stream, with the split plan for ``capacity``
    slots and that stream's workspace; raise on the CUDA error it
    returns."""
    from ._build import load_library
    lib = load_library("decode_attention")
    null = ctypes.c_void_p(0)
    quant = k_scale is not None
    b, h, _, d = q.shape
    hkv = k.shape[1]
    split_len, n_splits, n_groups, group = decode_split_plan(
        b, hkv, h // hkv, capacity)
    units = b * hkv * n_groups
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, counters = _decode_workspace(
        q.device, stream, units * n_splits * group * (d + 2), units)
    ptrs = [_ptr(q), _ptr(k), _ptr(v),
            _ptr(k_scale) if quant else null,
            _ptr(v_scale) if quant else null, _ptr(pos_v)]
    if table is not None:
        ptrs.append(_ptr(table))
    err = getattr(lib, entry)(
        _QTYPES[q.dtype], _CTYPES[k.dtype], d, *ptrs, _ptr(out), _ptr(ws),
        _ptr(counters), *dims, split_len, ctypes.c_float(sm_scale),
        ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({lib.decode_attention_error(err).decode()})")


# -- paged decode (K8, K9) -------------------------------------------------

# Keys per tile of the CUDA kernel (kTile in csrc/decode_attention.cu): on
# the GPU a page must hold whole tiles, so no tile straddles two pages.
KERNEL_PAGE_MULTIPLE = 32


def _check_paged_args(q, k_pool, k_scale, v_scale):
    """The JAX ``decode_attention_paged`` argument checks, with its
    messages; returns (b, h, hkv, page, d)."""
    b, h, sq, d = q.shape
    if sq != 1:
        raise ValueError(f"decode_attention_paged takes single-token "
                         f"queries, got sq={sq}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    p_blocks, hkv, page, _ = k_pool.shape
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    if page % 8 or (page < 128 and p_blocks > 1):
        raise ValueError(
            f"page size {page} must be 8-aligned, and >= 128 whenever the "
            f"pool holds more than one page (got {p_blocks} pages; a "
            f"single-page pool tolerates shorter pages since no block-table "
            f"indirection happens)")
    return b, h, hkv, page, d


def decode_attention_paged_plain(q, k_pool, v_pool, table, pos, *,
                                 k_scale=None, v_scale=None,
                                 sm_scale: float | None = None):
    """Plain-PyTorch paged decode attention, the same function as the
    kernel.

    ``q`` (B, H, 1, D); pools (P, Hkv, page, D); ``table`` (B, n_pages)
    int32, entry j the pool page holding cache slots [j*page, (j+1)*page);
    ``pos`` a scalar or (B,).  Sequence b's logical block j is pool page
    ``table[b, min(j, pos[b] // page)]``: the column index is clamped
    BEFORE the table is read, so entries past a sequence's live pages
    (garbage, or out of the pool's range) are never read, and neither is
    any pool page they would name.  The gathered (B, Hkv, n_pages * page,
    D) view then goes through ``decode_attention_plain``, whose pos bound
    masks the repeated last page.  int8 scale pools (P, Hkv, page, 1)
    float32 ride the same lookup.  Returns (B, H, 1, D)."""
    b, h, hkv, page, d = _check_paged_args(q, k_pool, k_scale, v_scale)
    n_pages = table.shape[1]
    pos_v = _pos_vector(pos, b, q.device).long()
    col = torch.minimum(torch.arange(n_pages, device=q.device)[None],
                        (pos_v // page)[:, None])
    pids = torch.gather(table.to(q.device).long(), 1, col)  # (B, n_pages)

    def view(pool):
        w = pool.shape[-1]
        return (pool[pids].permute(0, 2, 1, 3, 4)
                .reshape(b, hkv, n_pages * page, w))

    scales = {}
    if k_scale is not None:
        scales = dict(k_scale=view(k_scale), v_scale=view(v_scale))
    return decode_attention_plain(q, view(k_pool), view(v_pool), pos_v,
                                  sm_scale=sm_scale, **scales)


def decode_attention_paged(q, k_pool, v_pool, table, pos, *, k_scale=None,
                           v_scale=None, sm_scale: float | None = None):
    """Single-token decode attention over a paged KV pool (semantics of
    ``decode_attention_paged_plain``).

    On CUDA tensors this launches the paged decode kernel (K8; K9 when the
    int8 scale pools are given) on the current stream and adds one to
    ``decode_attention_paged.launches``.  The kernel is ``decode_attention``'s
    (the same dtypes, head_dim 64 or 128, 1 to 16 query heads per kv
    head) with one more limit: the page must be a multiple of the kernel's
    32-key tile, so that a tile never straddles two pages (serving uses
    512).  It reads no table entry past ``pos[b] // page`` and no pool row
    past ``pos[b]``.  Anything else on CUDA raises.  On CPU tensors the
    plain version runs (no launch is counted)."""
    b, h, hkv, page, d = _check_paged_args(q, k_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return decode_attention_paged_plain(q, k_pool, v_pool, table, pos,
                                            k_scale=k_scale, v_scale=v_scale,
                                            sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_paged: unsupported device "
                         f"{q.device}")
    name = "paged decode kernel"
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    quant = k_scale is not None
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    if h // hkv > KERNEL_MAX_GROUP:
        raise ValueError(f"{name} takes at most {KERNEL_MAX_GROUP} query "
                         f"heads per kv head, got {h // hkv}")
    if q.dtype not in _QTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16 q, got "
                         f"{q.dtype}")
    if page % KERNEL_PAGE_MULTIPLE:
        raise ValueError(f"{name} takes pages of a multiple of "
                         f"{KERNEL_PAGE_MULTIPLE} rows (whole 32-key tiles), "
                         f"got page {page}")
    want = torch.int8 if quant else q.dtype
    if k_pool.dtype != want or v_pool.dtype != want:
        raise ValueError(f"{name}: pools must be {want} for q {q.dtype}, got "
                         f"{k_pool.dtype}/{v_pool.dtype}")
    if v_pool.shape != k_pool.shape or k_pool.shape[3] != d:
        raise ValueError(f"{name}: pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if table.ndim != 2 or table.shape[0] != b or table.dtype != torch.int32:
        raise ValueError(f"{name}: table must be int32 (B, n_pages) with "
                         f"B = {b}, got {table.dtype} {tuple(table.shape)}")
    tensors = [q, k_pool, v_pool, table]
    if quant:
        sshape = k_pool.shape[:3] + (1,)
        if (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or k_scale.shape != sshape or v_scale.shape != sshape):
            raise ValueError(f"{name}: scale pools must be float32 "
                             f"(P, Hkv, page, 1) = {tuple(sshape)}")
        tensors += [k_scale, v_scale]
    _check_decode_operands(name, q, tensors)
    pos_v = _pos_vector(pos, b, q.device)
    out = torch.empty_like(q)
    _decode_launch("decode_attention_paged_launch", q, k_pool, v_pool,
                   k_scale, v_scale, pos_v, out,
                   (b, h, hkv, page, table.shape[1]), page * table.shape[1],
                   sm_scale, table=table)
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0
