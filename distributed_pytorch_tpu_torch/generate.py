"""Autoregressive decoding with a KV cache: the port of the JAX package's
generate.py, contiguous-cache and paged-pool paths.

Per-layer K/V caches are ``{"layer{i}": {"k", "v"[, "ks", "vs"]}}`` dicts of
(B, Hkv, S, Dh) tensors, as in the JAX package, or of (P, Hkv, page, Dh)
page POOLS (``init_paged_cache``) that sequences own through a
(B, n_pages) block table.  Unlike JAX's immutable arrays, the port's caches
are UPDATED IN PLACE: ``_forward_cached`` writes each new K/V row into the
cache tensors it is given (and returns the same dict for the JAX
signature's sake).

Single-token decode goes through ``ops.attention.decode_attention`` (the
CUDA decode kernel on the GPU) when ``use_decode_kernel`` is set, and
through ``decode_attention_paged`` over a pool; prefill and the
multi-token ragged window (``verify_step_ragged``, the suffix prefill of
prefix caching) attend through ``attention_reference`` with a
cache-validity bias.  Tensor-parallel decode (``tp_axis``) is refused
until slice 5 (ROADMAP.md queue 1); speculative decoding
(``generate_speculative``, ``generate_lookup``) is not ported yet
(slice 3b).
"""

from __future__ import annotations

import numpy as np
import torch

from .models import transformer as tfm
from .models.transformer import not_ported
from .ops.attention import (NEG_INF, attention_reference, decode_attention,
                            decode_attention_paged)
from .utils.device import resolve_device

Cache = dict[str, dict[str, torch.Tensor]]

PARALLEL_SLICE = tfm.PARALLEL_SLICE

# int8 KV quantization floor: a zero row quantizes against this scale
# instead of dividing by zero (dequantized zeros stay exactly zero).
KV_SCALE_EPS = 1e-8


def canon_kv_dtype(kv_dtype):
    """Normalize a ``kv_dtype`` knob: None (store K/V in the compute dtype)
    or int8 (quantized cache with per-row scales), given as ``"int8"``,
    ``torch.int8`` or ``numpy.int8``."""
    if kv_dtype is None:
        return None
    if kv_dtype is torch.int8:
        return torch.int8
    try:
        ok = np.dtype(kv_dtype) == np.dtype(np.int8)
    except TypeError:
        ok = False
    if ok:
        return torch.int8
    raise ValueError(f"unsupported kv_dtype {kv_dtype!r}: expected None "
                     f"or int8")


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 row quantization: ``x`` (..., Dh) -> (int8 values,
    float32 scales (..., 1)), scale = absmax / 127 per row, round half to
    even, clip to +-127."""
    x32 = x.float()
    scale = x32.abs().amax(-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=KV_SCALE_EPS)
    q = torch.clamp(torch.round(x32 / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=None):
    """Inverse of ``quantize_kv``: int8 rows x their (..., 1) scales."""
    x = q.float() * scale
    return x.to(dtype) if dtype is not None else x


def kv_bytes_per_token(cfg: tfm.TransformerConfig, dtype=torch.float32,
                       kv_dtype=None, kv_heads: int | None = None) -> int:
    """Device bytes one cached token position costs across all layers
    (K + V + scales)."""
    hk = kv_heads or cfg.kv_heads
    if canon_kv_dtype(kv_dtype) is not None:
        per_head = 2 * (cfg.head_dim + 4)  # int8 row + f32 scale, K and V
    else:
        itemsize = torch.empty((), dtype=dtype or torch.float32).element_size()
        per_head = 2 * cfg.head_dim * itemsize
    return per_head * hk * cfg.n_layers


def _kv_leaves(shape, dtype, kv_dtype, dev) -> dict[str, torch.Tensor]:
    if canon_kv_dtype(kv_dtype) is not None:
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.zeros(sshape, device=dev),
                "vs": torch.zeros(sshape, device=dev)}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def init_cache(cfg: tfm.TransformerConfig, batch: int, max_len: int,
               dtype=torch.float32, kv_heads: int | None = None,
               kv_dtype=None, device: str | torch.device = "cuda") -> Cache:
    """Zeroed per-layer K/V buffers (B, kv_heads, max_len, head_dim); with
    ``kv_dtype=int8`` int8 K/V plus float32 scales ``ks``/``vs``
    (..., max_len, 1)."""
    dev = resolve_device(device)
    shape = (batch, kv_heads or cfg.kv_heads, max_len, cfg.head_dim)
    return {f"layer{i}": _kv_leaves(shape, dtype, kv_dtype, dev)
            for i in range(cfg.n_layers)}


def init_paged_cache(cfg: tfm.TransformerConfig, n_pages: int,
                     page: int = 512, dtype=torch.float32,
                     kv_heads: int | None = None, kv_dtype=None,
                     device: str | torch.device = "cuda") -> Cache:
    """Zeroed per-layer PAGED K/V pools (n_pages, kv_heads, page,
    head_dim): sequences own pages through a block table instead of a
    contiguous per-sequence buffer (serve.py paged mode), so cache memory
    scales with the pages allocated, not slots x max_len.  With
    ``kv_dtype=int8`` the pools are int8 with per-row scale pools
    ``ks``/``vs`` (n_pages, kv_heads, page, 1) that ride the same block
    tables."""
    dev = resolve_device(device)
    shape = (n_pages, kv_heads or cfg.kv_heads, page, cfg.head_dim)
    return {f"layer{i}": _kv_leaves(shape, dtype, kv_dtype, dev)
            for i in range(cfg.n_layers)}


def pad_cache_len(n: int) -> int:
    """Round a cache length up to whole 512-slot blocks."""
    return -(-n // 512) * 512


def default_decode_kernel(flag: bool | None,
                          device: str | torch.device = "cuda") -> bool:
    """Resolve a decode_kernel tri-state: None = the kernel on a CUDA
    device, the plain attention path elsewhere."""
    return torch.device(device).type == "cuda" if flag is None else flag


def _forward_cached(params, cache: Cache, tokens: torch.Tensor,
                    pos: torch.Tensor, write_at, *,
                    cfg: tfm.TransformerConfig, dtype=None, tp_axis=None,
                    unembed_last_only: bool = False, unembed_at=None,
                    k_len: int | None = None,
                    use_decode_kernel: bool = False, page_table=None):
    """Cache-backed forward over a (B, S) token block at positions ``pos``,
    writing each layer's K/V into cache slots [write_at, write_at + S).
    Returns ((B, S, vocab) float32 logits, cache).  The cache is updated in
    place.

    Modes: prefill (``write_at=0``, ``pos`` (S,)); lockstep decode (S = 1,
    ``pos`` (1,), ``write_at`` an int); ragged decode (S = 1, ``pos``
    (B, 1), ``write_at`` a (B,) tensor of per-sequence offsets); the
    multi-token ragged window (S > 1, ``pos`` (B, S)), whose ``write_at``
    is a (B, S) matrix of per-TOKEN write positions, already clamped by the
    caller at each sequence's allocated frontier, written as one scatter.
    Query row j attends cache slots <= pos[j]: through the
    decode kernel for single-token steps with ``use_decode_kernel``, else
    through ``attention_reference`` with a NEG_INF validity bias over the
    first ``k_len`` slots.

    With ``page_table`` (B, n_pages) the cache leaves are (P, Hkv, page,
    Dh) pools and sequence b's slot p lives in pool page
    ``page_table[b, p // page]`` at row ``p % page``.  Single-token decode
    then goes through ``decode_attention_paged`` (it must use the kernel
    path); the multi-token window scatters its writes through the table and
    reads a contiguous per-sequence view gathered from the first
    ``ceil(k_len / page)`` table columns (``k_len`` is then the caller's
    live-depth hint; without it the whole table is gathered), dequantized
    under int8."""
    if tp_axis is not None:
        raise not_ported("tensor-parallel decode (tp_axis)", PARALLEL_SLICE)
    s = tokens.shape[1]
    ragged = pos.ndim == 2
    multi_ragged = ragged and s > 1
    kernel_path = use_decode_kernel and s == 1
    if page_table is not None:
        if not ((kernel_path or multi_ragged) and ragged):
            raise ValueError("page_table requires ragged per-sequence "
                             "positions, and single-token decode must use "
                             "the kernel path (use_decode_kernel=True)")
    if multi_ragged and write_at.ndim != 2:
        raise ValueError("a multi-token ragged forward needs (B, S) "
                         "per-token write positions")
    x = params["embed"][tokens]
    if dtype is not None:
        x = x.to(dtype)
    first = next(iter(cache.values()))
    k_len_hint = k_len
    k_len = k_len or first["k"].shape[2]
    gather_cols = 0
    if page_table is not None and multi_ragged:
        # the gathered view spans the table's first ceil(k_len / page)
        # columns (the live-depth hint) or the whole table; the per-row pos
        # bias masks everything beyond each sequence's own depth
        page = first["k"].shape[2]
        gather_cols = page_table.shape[1]
        if k_len_hint:
            gather_cols = min(-(-k_len_hint // page), gather_cols)
        k_len = gather_cols * page
    if not kernel_path:
        slot = torch.arange(k_len, device=x.device)
        if ragged:  # (B, 1, S, k_len)
            bias = torch.where(slot[None, None] <= pos[:, :, None], 0.0,
                               NEG_INF)[:, None]
        else:
            bias = torch.where(slot[None] <= pos[:, None], 0.0,
                               NEG_INF)[None, None]
    quant = "ks" in first
    bidx = torch.arange(tokens.shape[0], device=x.device)
    if page_table is not None:
        # token at position p lands in pool page table[b, p // page], row
        # p % page: (B, 1) positions for single-token decode, (B, S) for
        # the window
        page = first["k"].shape[2]
        table = page_table.long()
        w = write_at.long().reshape(len(table), -1)
        pids, offs = torch.gather(table, 1, w // page), w % page
    elif ragged:  # (B,) single-token, (B, S) for the window
        widx = write_at.long()
    else:
        w0 = int(write_at)

    for i in range(cfg.n_layers):
        lp = tfm.layer(params, i)
        c = cache[f"layer{i}"]
        h = tfm.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = tfm.qkv(lp, h, pos, cfg.rope_theta)
        if quant:
            kq, ksc = quantize_kv(k)
            vq, vsc = quantize_kv(v)
            pairs = (("k", kq), ("v", vq), ("ks", ksc), ("vs", vsc))
        else:
            pairs = (("k", k), ("v", v))
        for name, u in pairs:
            leaf = c[name]
            if page_table is not None:
                # pool[pids[b, j], :, offs[b, j]] = u[b, :, j]; colliding
                # (clamped) rows resolve arbitrarily and are never read
                leaf[pids, :, offs] = u.transpose(1, 2).to(leaf.dtype)
            elif multi_ragged:  # cache[b, :, widx[b, j]] = u[b, :, j]
                leaf[bidx[:, None], :, widx] = u.transpose(1, 2).to(
                    leaf.dtype)
            elif ragged:  # cache[b, :, write_at[b]] = u[b, :, 0]
                leaf[bidx, :, widx] = u[:, :, 0].to(leaf.dtype)
            else:
                leaf[:, :, w0:w0 + s] = u.to(leaf.dtype)
        if kernel_path and page_table is not None:
            o = decode_attention_paged(q, c["k"], c["v"], page_table,
                                       pos[:, 0], k_scale=c.get("ks"),
                                       v_scale=c.get("vs"))
        elif kernel_path:
            o = decode_attention(q, c["k"], c["v"],
                                 pos[:, 0] if ragged else pos[0],
                                 k_scale=c.get("ks"), v_scale=c.get("vs"))
        else:
            if page_table is not None:
                # contiguous per-sequence view of the first gather_cols
                # table columns: (B, cols, Hkv, page, w) -> (B, Hkv, k_len, w)
                tbl = table[:, :gather_cols]

                def view(leaf):
                    return (leaf[tbl].transpose(1, 2)
                            .reshape(len(tbl), leaf.shape[1], k_len,
                                     leaf.shape[3]))
            else:
                def view(leaf):
                    return leaf[:, :, :k_len]
            ka, va = view(c["k"]), view(c["v"])
            if quant:
                ka = dequantize_kv(ka, view(c["ks"]))
                va = dequantize_kv(va, view(c["vs"]))
            ka, va = ka.to(q.dtype), va.to(q.dtype)
            if q.shape[1] != ka.shape[1]:
                rep = q.shape[1] // ka.shape[1]
                ka = ka.repeat_interleave(rep, dim=1)
                va = va.repeat_interleave(rep, dim=1)
            o = attention_reference(q, ka, va, bias=bias)
        x = x + tfm.attn_out(lp, o)
        h = tfm.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + tfm.mlp(lp, h)

    x = tfm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if unembed_last_only:
        x = x[:, -1:]
    elif unembed_at is not None:
        x = x[:, int(unembed_at):int(unembed_at) + 1]
    logits = x.float() @ params["embed"].float().T
    return logits, cache


def decode_step(params, cache: Cache, token: torch.Tensor, pos: int, *,
                cfg: tfm.TransformerConfig, dtype=None, tp_axis=None,
                k_len: int | None = None, use_decode_kernel: bool = False):
    """One token per sequence, all at position ``pos``: (B,) ids ->
    ((B, vocab) logits, cache).  ``k_len`` bounds the plain path's read;
    the kernel's bound is the exact ``pos+1``, so the two are exclusive."""
    if use_decode_kernel and k_len is not None:
        raise ValueError(
            "k_len is ignored when use_decode_kernel=True (the kernel's "
            "read bound is the exact dynamic pos+1); pass one or the other")
    pos = int(pos)
    logits, cache = _forward_cached(
        params, cache, token[:, None],
        torch.tensor([pos], device=token.device), pos, cfg=cfg, dtype=dtype,
        tp_axis=tp_axis, k_len=k_len, use_decode_kernel=use_decode_kernel)
    return logits[:, 0], cache


def decode_step_ragged(params, cache: Cache, token: torch.Tensor,
                       pos: torch.Tensor, *, cfg: tfm.TransformerConfig,
                       dtype=None, tp_axis=None,
                       use_decode_kernel: bool = False, page_table=None):
    """One token per sequence at PER-SEQUENCE positions: (B,) ids at (B,)
    positions -> ((B, vocab) logits, cache).  Sequence b reads exactly its
    own ``pos[b]+1`` cache prefix and writes its K/V at ``pos[b]``: the
    step primitive of continuous batching (serve.py)."""
    logits, cache = _forward_cached(
        params, cache, token[:, None], pos[:, None], pos, cfg=cfg,
        dtype=dtype, tp_axis=tp_axis, use_decode_kernel=use_decode_kernel,
        page_table=page_table)
    return logits[:, 0], cache


def verify_step_ragged(params, cache: Cache, tokens: torch.Tensor,
                       pos: torch.Tensor, write_pos: torch.Tensor, *,
                       cfg: tfm.TransformerConfig, dtype=None, tp_axis=None,
                       page_table=None, k_len: int | None = None):
    """MULTI-token ragged forward: (B, W) tokens at per-sequence positions
    ``pos`` (B, W) -> ((B, W, vocab) logits, cache).  ``write_pos`` (B, W)
    gives each token's cache write position, already clamped at the
    sequence's allocated frontier by the caller (rows past the accepted
    prefix are garbage, never read: reads are pos-bounded).  Attention runs
    the bias path with exact per-row ``slot <= pos`` bounds; a paged pool
    is gathered into its contiguous per-sequence view, bounded to the first
    ``ceil(k_len / page)`` table columns when the caller passes ``k_len``
    (every live row's positions must stay below it).  The batcher's suffix
    prefill of a shared-prefix admission (serve.py, prefix caching) runs
    through it."""
    return _forward_cached(params, cache, tokens, pos, write_pos, cfg=cfg,
                           dtype=dtype, tp_axis=tp_axis,
                           page_table=page_table, k_len=k_len)


def _gumbel_argmax(generator: torch.Generator | None,
                   logits: torch.Tensor) -> torch.Tensor:
    """A categorical draw per row by the Gumbel-max trick (what
    ``jax.random.categorical`` does; the draws are not JAX's)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), -1)


def _filter_logits(logits, temperature: float, top_k: int | None,
                   top_p: float | None):
    """Temperature-scale + top-k/top-p mask (NEG_INF outside the keep set)
    over the last axis; requires ``temperature > 0``.  Both thresholds
    come from one descending sort of the scaled distribution; top-p is the
    smallest prefix with mass >= p on the FULL distribution, and the masks
    intersect."""
    scaled = logits / temperature
    v = logits.shape[-1]
    want_k = top_k is not None and 0 < top_k < v
    want_p = top_p is not None and top_p < 1.0
    if not want_k and not want_p:
        return scaled
    sorted_desc = torch.sort(scaled, -1, descending=True).values
    masked = scaled
    neg = torch.full((), NEG_INF, device=logits.device)
    if want_k:
        kth = sorted_desc[..., top_k - 1:top_k]
        masked = torch.where(scaled < kth, neg, masked)
    if want_p:
        probs = torch.softmax(sorted_desc, -1)
        exclusive_cum = torch.cumsum(probs, -1) - probs
        nkeep = torch.sum(exclusive_cum < top_p, -1)
        pidx = torch.clamp(nkeep - 1, 0, v - 1)
        pth = torch.gather(sorted_desc, -1, pidx[..., None])
        masked = torch.where(scaled < pth, neg, masked)
    return masked


def _sample(generator, logits, temperature: float, top_k: int | None,
            top_p: float | None = None):
    """Static-parameter sampling: greedy (first maximal index) at
    temperature 0, else a categorical draw from the warped distribution."""
    if temperature == 0.0:
        return torch.argmax(logits, -1).to(torch.int32)
    return _gumbel_argmax(
        generator, _filter_logits(logits, temperature, top_k, top_p)
    ).to(torch.int32)


def filter_per_seq(logits, temperature, top_k, top_p):
    """PER-ROW ``_filter_logits`` with (B,)-vector parameters.
    ``temperature`` <= 0 rows are divided by 1e-6; ``top_k`` 0 and
    ``top_p`` >= 1 disable their filters; threshold ties keep all tied
    tokens."""
    v = logits.shape[-1]
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, -1, descending=True).values
    neg = torch.full((), NEG_INF, device=logits.device)
    k = torch.clamp(top_k.long(), 0, v)
    kidx = torch.where(k > 0, k - 1, v - 1)
    kth = torch.gather(sorted_desc, 1, kidx[:, None])
    masked = torch.where((k[:, None] > 0) & (scaled < kth), neg, scaled)
    probs = torch.softmax(sorted_desc, -1)
    exclusive_cum = torch.cumsum(probs, -1) - probs
    nkeep = torch.sum(exclusive_cum < top_p[:, None], -1)
    pidx = torch.clamp(nkeep - 1, 0, v - 1)
    pth = torch.gather(sorted_desc, 1, pidx[:, None])
    return torch.where((top_p[:, None] < 1.0) & (scaled < pth), neg, masked)


def sample_per_seq(generator, logits, temperature, top_k, top_p):
    """Sampling with PER-ROW parameters: ``logits`` (B, V); ``temperature``
    (B,) float32, <= 0 means greedy; ``top_k`` (B,) int, 0 disables;
    ``top_p`` (B,) float32, >= 1 disables."""
    greedy = torch.argmax(logits, -1).to(torch.int32)
    masked = filter_per_seq(logits, temperature, top_k, top_p)
    sampled = _gumbel_argmax(generator, masked).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, sampled)


def generate(params, prompt, generator: torch.Generator | int | None = None,
             *, cfg: tfm.TransformerConfig, max_new: int,
             temperature: float = 1.0, top_k: int | None = None,
             top_p: float | None = None, dtype=None,
             eos_id: int | None = None, decode_segments: int = 8,
             decode_kernel: bool | None = None, kv_dtype=None,
             device: str | torch.device = "cuda") -> torch.Tensor:
    """Sample ``max_new`` tokens after ``prompt`` (B, S0); returns
    (B, S0 + max_new) int32 on ``device``.

    One batched prefill through the cache, then one decode step per token.
    ``dtype`` selects the compute and KV-cache dtype; ``kv_dtype="int8"``
    stores the cache quantized with per-row scales.  With the decode
    kernel (the default on CUDA) each step reads exactly ``pos+1`` cache
    slots; without it, decode runs in ``decode_segments`` segments, each
    reading a static prefix of the cache.  With ``eos_id``, a sequence
    that samples it keeps emitting it.  ``generator`` seeds sampling (a
    ``torch.Generator`` on ``device``, or an int seed); greedy decoding
    (``temperature=0``) does not draw."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    tfm._refuse_moe(cfg)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    b, s0 = prompt.shape
    use_kernel = default_decode_kernel(decode_kernel, dev)
    max_len = s0 + max_new
    if use_kernel:
        max_len = pad_cache_len(max_len)
    cache = init_cache(cfg, b, max_len, dtype=dtype or torch.float32,
                       kv_heads=params["layers.0.wk"].shape[1],
                       kv_dtype=kv_dtype, device=dev)
    logits, cache = _forward_cached(
        params, cache, prompt.long(), torch.arange(s0, device=dev), 0,
        cfg=cfg, dtype=dtype, unembed_last_only=True, k_len=s0)
    logits = logits[:, 0]
    n_seg = 1 if use_kernel else max(min(decode_segments, max_new), 1)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    toks = []
    start = 0
    for i in range(n_seg):
        end = (max_new * (i + 1)) // n_seg
        for t in range(start, end):
            tok = _sample(generator, logits, temperature, top_k, top_p)
            if eos_id is not None:
                tok = torch.where(done, torch.full_like(tok, eos_id), tok)
                done = done | (tok == eos_id)
            logits, cache = decode_step(
                params, cache, tok.long(), s0 + t, cfg=cfg, dtype=dtype,
                k_len=None if use_kernel else s0 + end,
                use_decode_kernel=use_kernel)
            toks.append(tok)
        start = end
    return torch.cat([prompt, torch.stack(toks, 1)], 1)
