"""The port's decode attention (distributed_pytorch_tpu_torch/ops/
attention.py) against the JAX package's Pallas ``decode_attention``, which
runs in interpret mode on the CPU as tests/test_attention.py runs it.

Inputs are made with numpy from a seed; float32 on both sides, atol/rtol
2e-5 (summation order differs).  The CUDA kernel itself is checked on the
card by the ``cuda``-marked tests at the end, which skip without a GPU.

The kernel's numeric recipe (csrc/decode_attention.cu) splits each
sequence into splits of L slots (``decode_split_plan``); within a split
each warp takes its rows of every 32-key tile, runs an online softmax
over them with p rounded to bf16 at its own running max, the warps merge
in order, and the live splits merge in ascending order.
``_recipe_decode`` replays it in numpy and is held against the Pallas
kernel on bf16 inputs within chip_smoke.py's bf16 tolerance, before any
card runs it.
"""

import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import generate as jgen
from distributed_pytorch_tpu.ops import attention as jattn
from distributed_pytorch_tpu_torch import generate as tgen
from distributed_pytorch_tpu_torch.ops import attention as tattn

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, 1, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _both(q, kc, vc, pos, ks=None, vs=None):
    j = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    t = tattn.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(np.asarray(pos)),
        k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs))
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_decode_plain_matches_jax_ragged(hkv):
    """GQA groups g = 4, 2, 1 with ragged per-sequence positions: the first
    slot, a block edge, mid-buffer and the last slot."""
    q, kc, vc = _inputs(hkv, 4, 4, hkv, 256, 64)
    pos = np.array([0, 127, 130, 255], np.int32)
    want, got = _both(q, kc, vc, pos)
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_plain_scalar_pos_matches_jax():
    q, kc, vc = _inputs(5, 2, 4, 2, 256, 64)
    want, got = _both(q, kc, vc, np.int32(77))
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_plain_int8_matches_jax():
    """int8 caches with per-row scales (K7's function): the JAX quantizer
    makes the operands, both sides dequantize."""
    q, kc, vc = _inputs(6, 3, 4, 2, 256, 64)
    kq, ks = jgen.quantize_kv(jnp.asarray(kc))
    vq, vs = jgen.quantize_kv(jnp.asarray(vc))
    pos = np.array([3, 128, 200], np.int32)
    want, got = _both(q, np.asarray(kq), np.asarray(vq), pos,
                      np.asarray(ks), np.asarray(vs))
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_plain_ignores_garbage_past_pos():
    """A dead tail of +-1e4 beyond each sequence's pos leaves the output
    exactly unchanged."""
    q, kc, vc = _inputs(7, 2, 4, 2, 256, 64)
    pos = np.array([100, 9], np.int32)
    clean = tattn.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(pos))
    for b, p in enumerate(pos):
        kc[b, :, p + 1:] = 1e4
        vc[b, :, p + 1:] = -1e4
    dirty = tattn.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(pos))
    assert torch.equal(clean, dirty)


def test_decode_validation_matches_jax():
    q = torch.zeros((1, 4, 2, 64))
    kc = vc = torch.zeros((1, 4, 256, 64))
    for fn in (tattn.decode_attention, tattn.decode_attention_plain):
        with pytest.raises(ValueError, match="single-token"):
            fn(q, kc, vc, 0)
        with pytest.raises(ValueError, match="group"):
            fn(torch.zeros((1, 3, 1, 64)), kc, vc, 0)
        with pytest.raises(ValueError, match="both"):
            fn(torch.zeros((1, 4, 1, 64)), kc, vc, 0,
               k_scale=torch.ones((1, 4, 256, 1)))


def test_decode_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors the wrapper runs the plain version and counts no
    kernel launch."""
    q, kc, vc = _inputs(8, 2, 4, 4, 64, 64)
    before = tattn.decode_attention.launches
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.tensor([5, 60]))
    got = tattn.decode_attention(*args)
    assert torch.equal(got, tattn.decode_attention_plain(*args))
    assert tattn.decode_attention.launches == before


@pytest.mark.parametrize("s", [256, 512, 1024, 8 * 17, 4096])
def test_fit_block_matches_jax(s):
    assert tattn._fit_block(tattn.DEFAULT_DECODE_BLOCK_K, s) == \
        jattn._fit_block(jattn.DEFAULT_DECODE_BLOCK_K, s)
    assert tattn.NEG_INF == jattn.NEG_INF


# -- the kernel's split recipe, replayed on the CPU ------------------------

CSRC = Path(tattn.__file__).resolve().parent.parent / "csrc"


def _kernel_consts():
    """(keys per tile, warps a block, query heads a block at g > 1) of
    csrc/decode_attention.cu, read from the source so the replay follows
    its kernel."""
    src = (CSRC / "decode_attention.cu").read_text()
    return (int(re.search(r"constexpr int kTile = (\d+);", src).group(1)),
            int(re.search(r"constexpr int kWarps = (\d+);", src).group(1)),
            int(re.search(r"constexpr int kHeadGroup = (\d+);", src)
                .group(1)))


def _bf16(x):
    """float32 rounded to the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _merge(parts):
    """Partial states (m, l, acc) merged in the given order: each rescaled
    to their common max."""
    m = np.max([p[0] for p in parts], axis=0)
    f = [np.exp(p[0] - m) for p in parts]
    l = sum(fi * p[1] for fi, p in zip(f, parts))
    acc = sum(fi[:, None] * p[2] for fi, p in zip(f, parts))
    return m, l, acc


def _recipe_decode(q, k, v, pos, *, split_len, ks=None, vs=None):
    """decode_kernel's arithmetic in numpy float32 on bf16 values: q (B, H,
    D); k, v (B, Hkv, S, D) bf16 values, or int8 with ks, vs (B, Hkv, S,
    1) scales (each element dequantized and rounded to bf16).  Per (b, kv
    head) with last = min(pos[b], S-1): live splits i of ``split_len``
    slots; in each, warp w takes rows [t*tile + w*wk, +wk) of every tile t
    whose first such row is live, in order, an online softmax over them (s
    = q.k * D^-0.5 in f32, -1e30 past last; p rounded to bf16 at the
    warp's running max); the warps merge in order, then the splits in
    ascending order; out = bf16(acc / max(l, 1e-30))."""
    tile, warps, _ = _kernel_consts()
    wk = tile // warps
    b_, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = h // hkv
    scale = np.float32(1 / np.sqrt(d))
    out = np.zeros((b_, h, d), np.float32)
    for b in range(b_):
        last = min(int(pos[b]), s - 1)
        for kv in range(hkv):
            kk = k[b, kv].astype(np.float32)
            vv = v[b, kv].astype(np.float32)
            if ks is not None:
                kk, vv = _bf16(kk * ks[b, kv]), _bf16(vv * vs[b, kv])
            qg = q[b, kv * g:(kv + 1) * g]
            splits = []
            for i in range(last // split_len + 1):
                per_warp = []
                for w in range(warps):
                    m = np.full(g, -1e30, np.float32)
                    l = np.zeros(g, np.float32)
                    acc = np.zeros((g, d), np.float32)
                    for t in range(split_len // tile):
                        r0 = i * split_len + t * tile + w * wk
                        if r0 > last:
                            break
                        rows = np.arange(r0, r0 + wk)
                        live = rows <= last
                        rr = np.minimum(rows, last)
                        sc = np.where(live, (qg @ kk[rr].T) * scale,
                                      np.float32(-1e30))
                        m_new = np.maximum(m, sc.max(1))
                        alpha = np.exp(m - m_new)
                        p = np.exp(sc - m_new[:, None])
                        l = alpha * l + p.sum(1, dtype=np.float32)
                        acc = alpha[:, None] * acc \
                            + _bf16(p) @ np.where(live[:, None], vv[rr], 0)
                        m = m_new
                    per_warp.append((m, l, acc))
                splits.append(_merge(per_warp))
            _, l, acc = _merge(splits)
            out[b, kv * g:(kv + 1) * g] = _bf16(
                acc / np.maximum(l, np.float32(1e-30))[:, None])
    return out


# chip_smoke.py's bf16 tolerance: each (sequence, head) row within
# min(1e-2, 5% of the reference row's RMS).
BF16_ABS, BF16_ROW_RMS = 1e-2, 5e-2


def _hold_bf16_rows(got, want):
    err = np.abs(got - want)
    rms = np.sqrt((want ** 2).mean(-1, keepdims=True))
    bound = np.minimum(BF16_ABS, BF16_ROW_RMS * rms)
    assert (err <= bound).all(), float((err / bound).max())


def _bf16_case(seed, b, h, hkv, s, d, quant):
    """bf16-valued q, and bf16-valued or int8 (JAX quantizer) caches."""
    q, kc, vc = (_bf16(x) for x in _inputs(seed, b, h, hkv, s, d))
    if not quant:
        return q, _bf16(kc), _bf16(vc), None, None
    kq, ks = (np.asarray(a) for a in jgen.quantize_kv(jnp.asarray(kc)))
    vq, vs = (np.asarray(a) for a in jgen.quantize_kv(jnp.asarray(vc)))
    return q, kq, vq, ks, vs


RECIPE_CASES = [(g, d, quant) for g in (1, 4) for d in (64, 128)
                for quant in (False, True)]


@pytest.mark.parametrize(
    "g,d,quant", RECIPE_CASES,
    ids=[f"g{g}-d{d}-{'int8' if q else 'bf16'}" for g, d, q in RECIPE_CASES])
def test_split_recipe_matches_jax(g, d, quant):
    """The kernel's split recipe against the Pallas decode kernel in
    interpret mode on the same bf16 inputs (7 sequences x 4 kv heads, S =
    256, so L = 64 slots): pos at 0, 31, 32, L-1, L, L+1 and S-1."""
    b, hkv, s = 7, 4, 256
    split_len = tattn.decode_split_plan(b, hkv, g, s)[0]
    assert split_len == 64
    pos = np.array([0, 31, 32, split_len - 1, split_len, split_len + 1,
                    s - 1], np.int32)
    q, kc, vc, ks, vs = _bf16_case(40 + g + d, b, hkv * g, hkv, s, d, quant)
    scales = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                        v_scale=jnp.asarray(vs))
    want = jattn.decode_attention(
        jnp.asarray(q, jnp.bfloat16),
        jnp.asarray(kc, jnp.int8 if quant else jnp.bfloat16),
        jnp.asarray(vc, jnp.int8 if quant else jnp.bfloat16),
        jnp.asarray(pos), **scales)
    got = _recipe_decode(q[:, :, 0], kc, vc, pos, split_len=split_len,
                         ks=ks, vs=vs)
    _hold_bf16_rows(got, np.asarray(want, np.float32)[:, :, 0])


def test_recipe_reads_the_kernel_constants():
    """The replay's tile, warps and head group are the kernel's, and the
    wrapper's limits follow them; at g = 16 (the kernel's largest group,
    four head groups of 4) over a cache no tile divides, the replay agrees
    with the plain version on bf16 values."""
    tile, warps, group = _kernel_consts()
    assert (tile, warps, group) == (32, 4, 4)
    assert tattn.KERNEL_PAGE_MULTIPLE == tile
    assert tattn.KERNEL_HEAD_GROUP == group
    b, hkv, g, s, d = 3, 1, tattn.KERNEL_MAX_GROUP, 300, 64
    q, kc, vc, _, _ = _bf16_case(50, b, hkv * g, hkv, s, d, False)
    pos = np.array([299, 0, 150], np.int32)
    want = tattn.decode_attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, kc, vc)),
        torch.from_numpy(pos))
    got = _recipe_decode(q[:, :, 0], kc, vc, pos,
                         split_len=tattn.decode_split_plan(b, hkv, g, s)[0])
    _hold_bf16_rows(got, want.float().numpy()[:, :, 0])


PLAN_SHAPES = [(8, 8, 1, 2048), (1, 1, 1, 2048), (5, 4, 4, 2048),
               (4, 2, 16, 1000), (64, 8, 1, 4096), (3, 1, 2, 77)]


@pytest.mark.parametrize("b,hkv,g,cap", PLAN_SHAPES,
                         ids=[f"b{b}-hkv{h}-g{g}-s{c}"
                              for b, h, g, c in PLAN_SHAPES])
def test_split_plan_covers_every_live_tile_once(b, hkv, g, cap):
    """At every depth the live splits [i*L, (i+1)*L), i <= last // L,
    hold each live 32-key tile exactly once, lie inside the launch's
    ceil(cap / L) splits, and every other split starts past last."""
    split_len, n_splits, n_groups, group = tattn.decode_split_plan(
        b, hkv, g, cap)
    tile = tattn.KERNEL_PAGE_MULTIPLE
    assert split_len % tile == 0 and n_splits * split_len >= cap
    assert n_groups * group >= g > (n_groups - 1) * group
    for last in range(cap):
        n_live = last // split_len + 1
        assert n_live <= n_splits
        owners = [[i for i in range(n_splits)
                   if i * split_len <= t * tile < (i + 1) * split_len]
                  for t in range(last // tile + 1)]
        assert all(len(o) == 1 and o[0] < n_live for o in owners)
        assert all(i * split_len > last for i in range(n_live, n_splits))


def test_split_plan_reads_no_pos_and_is_shared_by_dense_and_paged():
    """The plan takes host-known sizes only; L depends on B * Hkv * head
    groups alone, so a dense cache of S slots and a pool of page *
    n_pages slots split alike (and a capacity changes only the number of
    splits).  LM-base serving (8 slots x 8 kv heads): L = 256."""
    assert list(inspect.signature(tattn.decode_split_plan).parameters) \
        == ["b", "hkv", "g", "capacity"]
    assert tattn.decode_split_plan(8, 8, 1, 2048) == (256, 8, 1, 1)
    for b, hkv, g in ((8, 8, 1), (5, 4, 4), (1, 1, 1), (2, 2, 16)):
        lens = {tattn.decode_split_plan(b, hkv, g, cap)[0]
                for cap in (512 * 4, 2048, 512 * 9, 1000, 32)}
        assert len(lens) == 1


def test_decode_workspace_is_kept_per_device_and_stream():
    """Launches on one stream run in turn and share one workspace and one
    set of arrival counters; another stream, whose launches may overlap
    them, gets its own.  Counters start at 0, and a larger launch grows
    the pair of its stream only."""
    saved = dict(tattn._DECODE_WORKSPACE)
    tattn._DECODE_WORKSPACE.clear()
    try:
        cpu = torch.device("cpu")
        ws1, c1 = tattn._decode_workspace(cpu, 1, 100, 8)
        assert ws1.dtype == torch.float32 and c1.dtype == torch.int32
        assert ws1.numel() >= 100 and c1.numel() >= 8 and not c1.any()
        assert all(a is b for a, b in zip(
            tattn._decode_workspace(cpu, 1, 50, 4), (ws1, c1)))
        ws2, c2 = tattn._decode_workspace(cpu, 2, 100, 8)
        assert ws2.data_ptr() != ws1.data_ptr()
        assert c2.data_ptr() != c1.data_ptr()
        ws3, c3 = tattn._decode_workspace(cpu, 1, 200, 16)
        assert ws3.numel() >= 200 and c3.numel() >= 16 and not c3.any()
        assert all(a is b for a, b in zip(
            tattn._decode_workspace(cpu, 2, 100, 8), (ws2, c2)))
    finally:
        tattn._DECODE_WORKSPACE.clear()
        tattn._DECODE_WORKSPACE.update(saved)


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the decode kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,quant,d,g", [
    (torch.float32, False, 128, 1), (torch.float32, False, 64, 4),
    (torch.bfloat16, False, 128, 1), (torch.bfloat16, False, 64, 4),
    (torch.bfloat16, True, 128, 1), (torch.float32, True, 64, 2)])
def test_kernel_matches_plain_on_card(cuda, qdtype, quant, d, g):
    """The CUDA kernel against its plain version on the same inputs:
    float32 to 1e-5 (summation order), bf16 to 2e-2 (both round p and the
    output to bf16 at different points)."""
    hkv, b, s = 4, 4, 1000
    q, kc, vc = _inputs(9, b, hkv * g, hkv, s, d)
    q = torch.from_numpy(q).to(cuda, qdtype)
    kc, vc = torch.from_numpy(kc).to(cuda), torch.from_numpy(vc).to(cuda)
    kw = {}
    if quant:
        kc, kw["k_scale"] = tgen.quantize_kv(kc)
        vc, kw["v_scale"] = tgen.quantize_kv(vc)
    else:
        kc, vc = kc.to(qdtype), vc.to(qdtype)
    pos = torch.tensor([0, 31, 32, s - 1], dtype=torch.int32, device=cuda)
    before = tattn.decode_attention.launches
    out = tattn.decode_attention(q, kc, vc, pos, **kw)
    ref = tattn.decode_attention_plain(q, kc, vc, pos, **kw)
    torch.cuda.synchronize()
    assert tattn.decode_attention.launches == before + 1
    tol = 1e-5 if qdtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 1, 96), device=cuda)
    kc = torch.zeros((1, 2, 64, 96), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.decode_attention(q, kc, kc, 0)


# The split plan's edges on the card, as chip_smoke.py's phase 3 runs them:
# (sequences, kv heads, depths) over S = 2048 at D = 128, g = 1.  At 8 x 8
# the split is L = 256 slots: depths on both sides of every split edge,
# and a short sequence beside full-depth ones (its later splits empty); at
# 1 x 1 it is L = 32, and all 64 splits of the full depth are live.
CARD_SPLIT_CASES = [
    (8, 8, [255, 256, 511, 512, 767, 768, 1023, 1024]),
    (8, 8, [1279, 1280, 1535, 1536, 1791, 1792, 2047, 257]),
    (8, 8, [2047, 2047, 3, 2047, 0, 2047, 40, 2047]),
    (1, 1, [2047]),
]


def card_agreement(out, ref):
    """chip_smoke.py's tolerance: float32 to 1e-5; bf16 each (sequence,
    head) row within min(1e-2, 5% of its RMS)."""
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        return bool((err <= 1e-5).all())
    rms = ref.float().pow(2).mean(-1, keepdim=True).sqrt()
    return bool((err <= torch.clamp(0.05 * rms, max=1e-2)).all())


def repeats_bitwise(launch, first, n=50):
    """One more launch, then ``n`` back to back, all bitwise ``first``: an
    arrival counter left non-zero would change a later launch."""
    outs = [launch() for _ in range(n + 1)]
    torch.cuda.synchronize()
    return all(torch.equal(o, first) for o in outs)


def card_split_case(cuda, b, hkv, pos, qdtype, quant, seed=0):
    """Numpy-made (q, k, v, pos, scales) on the card at S = 2048, D = 128,
    g = 1: int8 caches quantized by the port, else in q's dtype."""
    q, kc, vc = _inputs(seed, b, hkv, hkv, 2048, 128)
    q = torch.from_numpy(q).to(cuda, qdtype)
    kc, vc = torch.from_numpy(kc).to(cuda), torch.from_numpy(vc).to(cuda)
    kw = {}
    if quant:
        kc, kw["k_scale"] = tgen.quantize_kv(kc)
        vc, kw["v_scale"] = tgen.quantize_kv(vc)
    else:
        kc, vc = kc.to(qdtype), vc.to(qdtype)
    return q, kc, vc, torch.tensor(pos, dtype=torch.int32, device=cuda), kw


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,quant", [
    (torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)])
def test_kernel_split_edges_on_card(cuda, qdtype, quant):
    """Every CARD_SPLIT_CASES case within chip_smoke.py's tolerance of the
    plain version, and bitwise equal to itself over 51 more launches."""
    for i, (b, hkv, pos) in enumerate(CARD_SPLIT_CASES):
        q, kc, vc, pt, kw = card_split_case(cuda, b, hkv, pos, qdtype, quant,
                                            seed=i)
        out = tattn.decode_attention(q, kc, vc, pt, **kw)
        ref = tattn.decode_attention_plain(q, kc, vc, pt, **kw)
        torch.cuda.synchronize()
        assert card_agreement(out, ref), (b, hkv, pos)
        assert repeats_bitwise(
            lambda: tattn.decode_attention(q, kc, vc, pt, **kw), out)
