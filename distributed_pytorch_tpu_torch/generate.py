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
multi-token ragged window (``verify_step_ragged``: the suffix prefill of
prefix caching, the verify window of speculation) attend through
``attention_reference`` with a cache-validity bias.  Speculative decoding
comes in two static flavours, ``generate_speculative`` (a draft model
proposes) and ``generate_lookup`` (prompt lookup proposes), and its
primitives (``lookup_proposals``, the rejection sampler) also serve the
batcher's in-block speculation (serve.py).  Each ``jax.lax.while_loop``
of the JAX package is a Python loop over device tensors here, and each
``jax.random`` split a draw from the caller's ``torch.Generator``.
An MoE layer decodes through ``_moe_dense``: every expert on every token,
combined by the token-choice top-k gates with no capacity and no drops
(the JAX package's decode MoE, not its training layer: where training
drops tokens the two differ by design, and a model trained with expert
choice is decoded approximately, with a warning).
Tensor-parallel decode (``tp_axis``) is refused until slice 5d-ii
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .models import transformer as tfm
from .models.transformer import not_ported
from .ops.moe import top_k_stable
from .ops.attention import (NEG_INF, attention_reference, decode_attention,
                            decode_attention_paged)
from .utils.device import resolve_device

Cache = dict[str, dict[str, torch.Tensor]]

TP_SERVING_SLICE = tfm.TP_SERVING_SLICE

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


def _warn_if_expert_choice(cfg: tfm.TransformerConfig) -> None:
    """Expert-choice routing has no autoregressive decode equivalent: its
    selection ranks tokens per expert over the whole batch, so decode
    falls back to capacity-free token-choice top-k mixing, whose mixtures
    differ from the training-time routing.  Warns, as the JAX package
    does, rather than raising."""
    if cfg.n_experts and cfg.moe_router == "experts":
        warnings.warn(
            "decoding a model trained with expert-choice routing "
            "(moe_router='experts'): decode uses capacity-free token-choice "
            "top-k mixing, which differs from the training-time routing — "
            "decode losses are not comparable to train/eval losses",
            stacklevel=3)


def _moe_dense(mp: dict, h: torch.Tensor, cfg: tfm.TransformerConfig
               ) -> torch.Tensor:
    """Capacity-free MoE for decode (the JAX ``_moe_dense``): every expert
    on every token, combined by the top-k gates (the raw probability for
    top-1, normalized over the pair for top-2) in a (T, E) weight matrix.
    ``mp`` is the layer's ``moe`` dict; (B, S, D) -> (B, S, D)."""
    b, s, d = h.shape
    hf = h.reshape(b * s, d)
    probs = torch.softmax(hf.float() @ mp["router"].float(), -1)
    top_probs, top_idx = top_k_stable(probs, cfg.moe_top_k)
    if cfg.moe_top_k > 1:
        top_probs = top_probs / top_probs.sum(-1, keepdim=True)
    weights = torch.einsum("tk,tke->te", top_probs,
                           F.one_hot(top_idx, cfg.n_experts).float())
    dt = hf.dtype
    g = F.silu(torch.einsum("td,edf->tef", hf, mp["w_gate"].to(dt)))
    u = torch.einsum("td,edf->tef", hf, mp["w_up"].to(dt))
    y = torch.einsum("tef,efd->ted", g * u, mp["w_down"].to(dt))
    out = torch.einsum("te,ted->td", weights.to(dt), y)
    return out.reshape(b, s, d)


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
        raise not_ported("tensor-parallel decode (tp_axis)", TP_SERVING_SLICE)
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
        if cfg.is_moe_layer(i):
            x = x + _moe_dense(lp["moe"], h, cfg)
        else:
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
                   logits: torch.Tensor, u: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """A categorical draw per row by the Gumbel-max trick (what
    ``jax.random.categorical`` does; the draws are not JAX's).  ``u``,
    uniforms of ``logits``' shape drawn by the caller, replaces the draw
    from ``generator``."""
    if u is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
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


def sample_per_seq(generator, logits, temperature, top_k, top_p, u=None):
    """Sampling with PER-ROW parameters: ``logits`` (B, V); ``temperature``
    (B,) float32, <= 0 means greedy; ``top_k`` (B,) int, 0 disables;
    ``top_p`` (B,) float32, >= 1 disables.  ``u`` (B, V) uniforms, drawn
    by the caller, replace the draw from ``generator``."""
    greedy = torch.argmax(logits, -1).to(torch.int32)
    masked = filter_per_seq(logits, temperature, top_k, top_p)
    sampled = _gumbel_argmax(generator, masked, u)
    return torch.where(temperature <= 0.0, greedy, sampled.to(torch.int32))


def lookup_proposals(stream: torch.Tensor, last_i: torch.Tensor, n_spec: int,
                     ngram: int) -> torch.Tensor:
    """PROMPT-LOOKUP proposals, shared by ``generate_lookup`` and the
    batcher's in-block speculation (serve.py): for each row of ``stream``
    (B, T), find the most recent earlier occurrence of the trailing
    ``ngram`` ending at index ``last_i`` (B,) and copy the ``n_spec``
    tokens that followed it; rows with no match (or a prefix shorter than
    the ngram) repeat the last token.  Proposals are free to be wrong:
    verification rejects them at the cost of a round's speculation."""
    b, total = stream.shape
    dev = stream.device
    last_i = last_i.long()
    nwin = total - ngram + 1
    jgrid = torch.arange(nwin, device=dev)[None]
    win_ok = torch.ones((b, nwin), dtype=torch.bool, device=dev)
    for o in range(ngram):
        tail = torch.gather(stream, 1, torch.clamp(
            last_i - (ngram - 1) + o, 0, total - 1)[:, None])
        win_ok &= stream[:, o:nwin + o] == tail
    # exclude the trailing ngram matching itself; window tokens and at
    # least the first continuation token must be already written
    win_ok &= jgrid <= (last_i - ngram)[:, None]
    win_ok &= (ngram <= last_i)[:, None]
    jbest = torch.amax(torch.where(win_ok, jgrid, -1), 1)
    base = torch.where(jbest >= 0, jbest + ngram, 0)
    idx = torch.clamp(base[:, None] + torch.arange(n_spec, device=dev)[None],
                      0, total - 1)
    props = torch.gather(stream, 1, idx)
    lastv = torch.gather(stream, 1, torch.clamp(last_i, 0, total - 1)[:, None])
    return torch.where((jbest >= 0)[:, None], props, lastv.expand(b, n_spec))


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
    _warn_if_expert_choice(cfg)
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


def _spec_prefill(params, prompt, cfg, dtype, max_len_pad):
    """Shared speculative prologue: prefill the model over the prompt and
    return ``(cache, (B, vocab) last-position logits)``."""
    b, s0 = prompt.shape
    dev = prompt.device
    cache = init_cache(cfg, b, max_len_pad, dtype=dtype or torch.float32,
                       kv_heads=params["layers.0.wk"].shape[1], device=dev)
    logits, cache = _forward_cached(
        params, cache, prompt.long(), torch.arange(s0, device=dev), 0,
        cfg=cfg, dtype=dtype, unembed_last_only=True, k_len=s0)
    return cache, logits[:, 0]


def _spec_epilogue(prompt, out, state, eos_id):
    """Shared speculative epilogue: eos-repeat padding (generate()'s
    fixed-shape convention), prompt concat, and the stats dict."""
    if eos_id is not None:
        seen = torch.cumsum((out == eos_id).to(torch.int32), 1) > 0
        out = torch.where(seen, torch.full_like(out, eos_id), out)
    tokens = torch.cat([prompt, out], 1)
    stats = {k: int(state[k]) for k in ("rounds", "drafted", "accepted")}
    return tokens, stats


def _spec_reject_tokens(generator, drafts, q, p):
    """Draft-distribution REJECTION SAMPLING (Leviathan / Chen et al.),
    over every speculated position at once: ``drafts`` (B, k) tokens drawn
    from the draft distributions ``q`` (B, k, V); ``p`` (B, k+1, V) the
    target's warped distributions at the same positions plus the one
    after.  Returns ``(match, g)``: ``match[b, j]`` accepts position j's
    draft with probability ``min(1, p_j(x_j) / q_j(x_j))``; ``g[b, j]`` is
    the token emitted after accepting a length-j prefix, a sample from the
    residual ``norm(max(p_j - q_j, 0))`` for j < k and from ``p_k`` for
    j = k (every draft accepted: the bonus token).  A zero residual can
    only arise where acceptance is certain; it falls back to p_j."""
    b, k, _ = q.shape
    d = drafts.long()[..., None]
    px = torch.gather(p[:, :k], 2, d)[..., 0]
    qx = torch.gather(q, 2, d)[..., 0]
    u = torch.rand((b, k), generator=generator, device=q.device)
    match = u * qx < px                              # u < p(x)/q(x)
    resid = torch.clamp(p[:, :k] - q, min=0.0)
    rs = resid.sum(-1, keepdim=True)
    resid = torch.where(rs > 0, resid / torch.where(rs > 0, rs, 1.0),
                        p[:, :k])
    repl = _gumbel_argmax(generator, torch.log(resid + 1e-38))
    bonus = _gumbel_argmax(generator, torch.log(p[:, -1] + 1e-38))
    return match, torch.cat([repl, bonus[:, None]], 1).to(torch.int32)


def _spec_accept_emit(drafts, g, done, n, buf, buf_off, n_spec, max_new,
                      eos_id, match=None):
    """One speculative round's accept + emit + scatter, shared by the
    draft-model and prompt-lookup paths.  ``drafts`` (B, n_spec)
    proposals, ``g`` (B, n_spec+1) the per-prefix-length continuation
    tokens (greedy: the target's argmaxes; sampled: the rejection
    sampler's); returns (``buf`` with the emissions written at columns
    ``buf_off + n``, n_emit, accepted count m, last emitted token, new
    done mask).  Greedy by default (``match=None``: draft j is accepted
    iff it equals the target's argmax after the accepted prefix).  The
    round emits drafts[:m] plus g[m], capped by eos and max_new."""
    b = drafts.shape[0]
    dev = drafts.device
    k_tok = n_spec + 1
    if match is None:
        match = drafts == g[:, :n_spec]
    m = torch.cumprod(match.to(torch.int32), 1).sum(1)
    j = torch.arange(k_tok, device=dev)[None]
    gm = torch.gather(g, 1, m[:, None].long())
    emit = torch.where(j < m[:, None], torch.cat([drafts, drafts[:, -1:]], 1),
                       gm.expand(b, k_tok))
    n_emit = torch.where(done, 0, m + 1)
    if eos_id is not None:
        # stop at the first emitted eos (inclusive)
        is_eos = emit == eos_id
        first_eos = torch.argmax(is_eos.to(torch.int32), 1)
        has_eos = torch.any(is_eos & (j < n_emit[:, None]), 1)
        n_emit = torch.where(has_eos, torch.minimum(n_emit, first_eos + 1),
                             n_emit)
    n_emit = torch.minimum(n_emit, max_new - n)
    cols = buf_off + n[:, None] + j
    valid = j < n_emit[:, None]
    width = buf.shape[1]
    # invalid entries land in a dropped extra column
    wide = torch.cat([buf, torch.zeros_like(buf[:, :1])], 1)
    wide.scatter_(1, torch.where(valid, cols, width).long(),
                  torch.where(valid, emit, 0).to(buf.dtype))
    buf = wide[:, :width]
    new_done = done | (n + n_emit >= max_new)
    if eos_id is not None:
        new_done = new_done | torch.any((emit == eos_id) & valid, 1)
    last_new = torch.gather(emit, 1, torch.clamp(
        n_emit - 1, min=0)[:, None].long())[:, 0]
    return buf, n_emit, m, last_new, new_done


def _spec_start(generator, logits0, b, temperature, top_k, top_p, eos_id):
    """The first emitted token (a warped sample, or the argmax) and the
    initial done mask."""
    if temperature > 0.0:
        t0 = _sample(generator, logits0, temperature, top_k, top_p)
    else:
        t0 = torch.argmax(logits0, -1).to(torch.int32)
    done0 = ((t0 == eos_id) if eos_id is not None
             else torch.zeros((b,), dtype=torch.bool, device=t0.device))
    return t0, done0


def generate_speculative(params, draft_params, prompt,
                         generator: torch.Generator | int | None = None, *,
                         cfg: tfm.TransformerConfig,
                         draft_cfg: tfm.TransformerConfig, max_new: int,
                         n_spec: int = 4, temperature: float = 0.0,
                         top_k: int | None = None, top_p: float | None = None,
                         dtype=None, eos_id: int | None = None,
                         decode_kernel: bool | None = None,
                         device: str | torch.device = "cuda"):
    """SPECULATIVE decoding: a small draft model proposes ``n_spec`` tokens
    per round, the target verifies them all in ONE (B, n_spec+1)-token
    forward, and the longest accepted prefix plus one continuation token
    are emitted.

    ``temperature == 0`` (default): greedy speculation, identical to the
    target's plain greedy decode.  ``temperature > 0``: the draft samples
    its proposals from its warped distribution q, the target accepts each
    with probability min(1, p/q) and a rejection resamples from the
    residual (``_spec_reject_tokens``): the emitted tokens are distributed
    exactly as the target's warped distribution.  Needs ``generator`` (a
    ``torch.Generator`` on ``device``, or an int seed).

    Cache rewind after a rejection is free: reads are position-bounded and
    stale rows are overwritten before the bound reaches them.  The draft
    decodes through the decode kernel on CUDA (``decode_kernel``); the
    verify window attends through ``attention_reference``.  Returns
    ``(tokens (B, S0 + max_new) int32, {"rounds", "drafted",
    "accepted"})``."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    b, s0 = prompt.shape
    k_tok = n_spec + 1
    sampled = temperature > 0.0
    if sampled and generator is None:
        raise ValueError("sampled speculative decoding (temperature > 0) "
                         "needs a generator")
    use_kernel = default_decode_kernel(decode_kernel, dev)
    max_len = pad_cache_len(s0 + max_new + k_tok)
    # prefill BOTH models over the prompt; t0 = the target's first token
    cache, logits0 = _spec_prefill(params, prompt, cfg, dtype, max_len)
    dcache, _ = _spec_prefill(draft_params, prompt, draft_cfg, dtype, max_len)
    t0, done = _spec_start(generator, logits0, b, temperature, top_k, top_p,
                           eos_id)
    out = torch.zeros((b, max_new), dtype=torch.int32, device=dev)
    out[:, 0] = t0
    pos = torch.full((b,), s0 - 1, dtype=torch.int32, device=dev)
    last = t0
    n = torch.ones((b,), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    st = {"rounds": 0, "drafted": zero, "accepted": zero}
    kgrid = torch.arange(k_tok, device=dev)[None]
    while bool(((n < max_new) & ~done).any()):
        # 1. the draft proposes n_spec tokens (greedy argmaxes, or samples
        # from its warped distribution).  One EXTRA step writes the last
        # proposal's own K/V row, which the next round reads when every
        # draft is accepted.
        tok, p, drafts, qprobs = last, pos, [], []
        for _ in range(n_spec + 1):
            p = p + 1
            lg, dcache = decode_step_ragged(
                draft_params, dcache, tok.long(), p, cfg=draft_cfg,
                dtype=dtype, use_decode_kernel=use_kernel)
            if sampled:
                warped = _filter_logits(lg, temperature, top_k, top_p)
                tok = _gumbel_argmax(generator, warped).to(torch.int32)
                qprobs.append(torch.softmax(warped, -1))
            else:
                tok = torch.argmax(lg, -1).to(torch.int32)
            drafts.append(tok)
        drafts = torch.stack(drafts[:n_spec], 1)
        # 2. the target verifies every proposal in ONE (B, k_tok) forward
        tokens_in = torch.cat([last[:, None], drafts], 1)
        vpos = pos[:, None] + 1 + kgrid
        vlogits, cache = _forward_cached(
            params, cache, tokens_in.long(), vpos, vpos, cfg=cfg,
            dtype=dtype, k_len=max_len)
        if sampled:
            pprobs = torch.softmax(
                _filter_logits(vlogits, temperature, top_k, top_p), -1)
            match, g = _spec_reject_tokens(
                generator, drafts, torch.stack(qprobs[:n_spec], 1), pprobs)
        else:
            match = None
            g = torch.argmax(vlogits, -1).to(torch.int32)
        # 3. accept the longest accepted prefix and write the emissions
        out, n_emit, m, last_new, new_done = _spec_accept_emit(
            drafts, g, done, n, out, 0, n_spec, max_new, eos_id, match=match)
        pos = torch.where(done, pos, pos + n_emit)
        last = torch.where(done | (n_emit == 0), last, last_new)
        st["rounds"] += 1
        st["drafted"] = st["drafted"] + torch.where(done, 0, n_spec).sum()
        st["accepted"] = st["accepted"] + torch.where(done, 0, m).sum()
        n = n + n_emit
        done = new_done
    return _spec_epilogue(prompt, out, st, eos_id)


def generate_lookup(params, prompt,
                    generator: torch.Generator | int | None = None, *,
                    cfg: tfm.TransformerConfig, max_new: int,
                    n_spec: int = 8, ngram: int = 2,
                    temperature: float = 0.0, top_k: int | None = None,
                    top_p: float | None = None, dtype=None,
                    eos_id: int | None = None,
                    device: str | torch.device = "cuda"):
    """PROMPT-LOOKUP speculative decoding: each round proposes the
    continuation of the most recent earlier occurrence of the trailing
    ``ngram`` in the prompt + generated stream (``lookup_proposals``), and
    the target verifies the ``n_spec`` proposals in one forward, as in
    ``generate_speculative``.  Greedy by default (identical to the
    target's greedy decode); at ``temperature > 0`` (needs ``generator``)
    a proposal is a point-mass draft: accepted with probability p(x),
    resampled from p without x on rejection, so the emitted tokens follow
    the target's warped distribution exactly.  Returns ``(tokens,
    stats)`` as ``generate_speculative``."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    b, s0 = prompt.shape
    k_tok = n_spec + 1
    sampled = temperature > 0.0
    if sampled and generator is None:
        raise ValueError("sampled lookup decoding (temperature > 0) needs a "
                         "generator")
    total = s0 + max_new
    max_len = pad_cache_len(total + k_tok)
    cache, logits0 = _spec_prefill(params, prompt, cfg, dtype, max_len)
    t0, done = _spec_start(generator, logits0, b, temperature, top_k, top_p,
                           eos_id)
    stream = torch.zeros((b, total), dtype=torch.int32, device=dev)
    stream[:, :s0] = prompt
    stream[:, s0] = t0
    pos = torch.full((b,), s0 - 1, dtype=torch.int32, device=dev)
    n = torch.ones((b,), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    st = {"rounds": 0, "drafted": zero, "accepted": zero}
    kgrid = torch.arange(k_tok, device=dev)[None]
    while bool(((n < max_new) & ~done).any()):
        last_i = s0 + n - 1
        last = torch.gather(stream, 1, last_i[:, None].long())[:, 0]
        drafts = lookup_proposals(stream, last_i, n_spec, ngram)
        tokens_in = torch.cat([last[:, None], drafts], 1)
        vpos = pos[:, None] + 1 + kgrid
        vlogits, cache = _forward_cached(
            params, cache, tokens_in.long(), vpos, vpos, cfg=cfg,
            dtype=dtype, k_len=max_len)
        if sampled:
            pprobs = torch.softmax(
                _filter_logits(vlogits, temperature, top_k, top_p), -1)
            q = torch.nn.functional.one_hot(
                drafts.long(), cfg.vocab_size).to(torch.float32)
            match, g = _spec_reject_tokens(generator, drafts, q, pprobs)
        else:
            match = None
            g = torch.argmax(vlogits, -1).to(torch.int32)
        stream, n_emit, m, _, new_done = _spec_accept_emit(
            drafts, g, done, n, stream, s0, n_spec, max_new, eos_id,
            match=match)
        pos = torch.where(done, pos, pos + n_emit)
        st["rounds"] += 1
        st["drafted"] = st["drafted"] + torch.where(done, 0, n_spec).sum()
        st["accepted"] = st["accepted"] + torch.where(done, 0, m).sum()
        n = n + n_emit
        done = new_done
    return _spec_epilogue(prompt, stream[:, s0:], st, eos_id)
