"""The port's paged decode attention (distributed_pytorch_tpu_torch/ops/
attention.py ``decode_attention_paged_plain`` / ``decode_attention_paged``)
against the JAX package's Pallas ``decode_attention_paged``, which runs in
interpret mode on the CPU as tests/test_attention.py runs it.

Inputs are made with numpy from a seed.  float32 on both sides, atol/rtol
2e-5 (summation order differs).  The CUDA kernels K8/K9 are checked on the
card by the ``cuda``-marked tests at the end, which skip without a GPU.
The kernel's split recipe (``_recipe_decode`` of test_torch_attention.py)
is held against the Pallas paged kernel on bf16 inputs here, reading the
pool through the table's live entries as K8/K9 do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import generate as jgen
from distributed_pytorch_tpu.ops import attention as jattn
from distributed_pytorch_tpu_torch import generate as tgen
from distributed_pytorch_tpu_torch.ops import attention as tattn
# by its module name (pytest puts tests/ on sys.path): an installed
# package named ``tests`` would shadow ``tests.test_torch_attention``
from test_torch_attention import (CARD_SPLIT_CASES, _bf16_case,
                                  _hold_bf16_rows, _recipe_decode,
                                  card_agreement, card_split_case,
                                  repeats_bitwise)

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU shapes: parallel test workers
    each running torch's default thread pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paged_case(seed, *, b=3, h=4, hkv=2, d=32, s=1024, page=512,
                poison=999_999):
    """A dense (B, Hkv, S, D) cache scattered page by page into a shuffled
    pool with spare garbage pages; table entries past each sequence's live
    pages are poisoned with ``poison`` (0: the garbage page 0; 999_999: far
    outside the pool)."""
    rng = np.random.default_rng(seed)
    n_pages = s // page
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    p_total = b * n_pages + 3
    perm = rng.permutation(b * n_pages) + 3  # pages 0-2 stay garbage
    k_pool = rng.standard_normal((p_total, hkv, page, d)).astype(np.float32)
    v_pool = rng.standard_normal((p_total, hkv, page, d)).astype(np.float32)
    table = np.zeros((b, n_pages), np.int32)
    for bb in range(b):
        for j in range(n_pages):
            pid = int(perm[bb * n_pages + j])
            k_pool[pid] = k[bb, :, j * page:(j + 1) * page]
            v_pool[pid] = v[bb, :, j * page:(j + 1) * page]
            table[bb, j] = pid
    return q, k, v, k_pool, v_pool, table


def _poison(table, pos, page, value):
    table = table.copy()
    for bb, p in enumerate(pos):
        table[bb, int(p) // page + 1:] = value
    return table


def _jax_paged(q, k_pool, v_pool, table, pos, ks=None, vs=None):
    return np.asarray(jattn.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(table), jnp.asarray(pos),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs)))


def _torch_paged(fn, q, k_pool, v_pool, table, pos, ks=None, vs=None):
    t = torch.from_numpy
    return fn(t(q), t(k_pool), t(v_pool), t(table), t(np.asarray(pos)),
              k_scale=None if ks is None else t(ks),
              v_scale=None if vs is None else t(vs)).numpy()


@pytest.mark.parametrize("hkv", [1, 2])
@pytest.mark.parametrize("poison", [0, 999_999])
def test_paged_plain_matches_jax_over_shuffled_pool(hkv, poison):
    """b=3 sequences of 1024 slots in 512-token pages over a shuffled pool;
    pos 37, 700 and 1023; poisoned table tails.  The port's plain version
    equals the JAX Pallas paged kernel, and equals its own dense plain
    version over the unscattered cache."""
    q, k, v, k_pool, v_pool, table = _paged_case(10 + hkv, hkv=hkv)
    pos = np.array([37, 700, 1023], np.int32)
    tbl_jax = _poison(table, pos, 512, 0)  # JAX reads clamp, never this
    tbl = _poison(table, pos, 512, poison)
    want = _jax_paged(q, k_pool, v_pool, tbl_jax, pos)
    got = _torch_paged(tattn.decode_attention_paged_plain, q, k_pool,
                       v_pool, tbl, pos)
    np.testing.assert_allclose(got, want, **TOL)
    dense = tattn.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, dense, **TOL)


def test_paged_plain_reads_no_table_entry_past_pos():
    """A table entry past pos // page is never read: poisoning it with an
    index far outside the pool leaves the output bitwise unchanged (a
    gather of the whole table would raise), as does garbage in the pool
    rows past pos within the live page."""
    q, _, _, k_pool, v_pool, table = _paged_case(20)
    pos = np.array([5, 511, 512], np.int32)
    clean = _torch_paged(tattn.decode_attention_paged_plain, q, k_pool,
                         v_pool, table, pos)
    k_dirty, v_dirty = k_pool.copy(), v_pool.copy()
    for bb, p in enumerate(pos):
        pid = table[bb, p // 512]
        k_dirty[pid, :, p % 512 + 1:] = 1e4
        v_dirty[pid, :, p % 512 + 1:] = -1e4
    dirty = _torch_paged(tattn.decode_attention_paged_plain, q, k_dirty,
                         v_dirty, _poison(table, pos, 512, 2 ** 31 - 1), pos)
    np.testing.assert_array_equal(dirty, clean)


def test_paged_plain_scalar_pos_and_wrapper_on_cpu():
    """A scalar pos broadcasts over the batch; on CPU tensors the wrapper
    runs the plain version and counts no launch."""
    q, _, _, k_pool, v_pool, table = _paged_case(21, b=2)
    want = _jax_paged(q, k_pool, v_pool, table, np.int32(600))
    before = tattn.decode_attention_paged.launches
    got = _torch_paged(tattn.decode_attention_paged, q, k_pool, v_pool,
                       table, np.int32(600))
    np.testing.assert_allclose(got, want, **TOL)
    assert tattn.decode_attention_paged.launches == before


def test_paged_int8_plain_matches_jax():
    """The int8 twin: int8 pools with (P, Hkv, page, 1) float32 scale
    pools riding the same lookup (the JAX quantizer makes the operands);
    against the JAX paged kernel and against the port's own dense int8
    decode over the same rows."""
    rng = np.random.default_rng(0)
    b, h, hkv, s, d, page = 2, 4, 2, 512, 32, 256
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    kq, ks = (np.array(a) for a in jgen.quantize_kv(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jgen.quantize_kv(jnp.asarray(v)))
    pos = np.array([100, 350], np.int32)
    per = s // page
    table = np.arange(1, b * per + 1, dtype=np.int32).reshape(b, per)

    def pool(x):
        w = x.shape[-1]
        p = np.zeros((b * per + 1, hkv, page, w), x.dtype)
        p[table.reshape(-1)] = (x.reshape(b, hkv, per, page, w)
                                .transpose(0, 2, 1, 3, 4)
                                .reshape(b * per, hkv, page, w))
        return p

    args = (q, pool(kq), pool(vq), table, pos, pool(ks), pool(vs))
    want = _jax_paged(*args)
    got = _torch_paged(tattn.decode_attention_paged_plain, *args)
    np.testing.assert_allclose(got, want, **TOL)
    t = torch.from_numpy
    dense = tattn.decode_attention_plain(t(q), t(kq), t(vq), t(pos),
                                         k_scale=t(ks), v_scale=t(vs))
    np.testing.assert_allclose(got, dense.numpy(), **TOL)


@pytest.mark.parametrize("fn", [tattn.decode_attention_paged,
                                tattn.decode_attention_paged_plain],
                         ids=["wrapper", "plain"])
def test_paged_validation_matches_jax(fn):
    """The port raises ValueError where the JAX wrapper raises, with the
    same messages: sq != 1, one scale without the other, heads that do
    not group, and a page that is not 8-aligned or below 128 in a
    multi-page pool."""
    q = np.zeros((1, 4, 1, 32), np.float32)
    pool = np.zeros((3, 2, 128, 32), np.float32)
    table = np.zeros((1, 2), np.int32)
    cases = [
        ("single-token", dict(q=np.zeros((1, 4, 2, 32), np.float32))),
        ("both", dict(ks=np.ones((3, 2, 128, 1), np.float32))),
        ("group", dict(q=np.zeros((1, 3, 1, 32), np.float32))),
        ("page size", dict(pool=np.zeros((3, 2, 100, 32), np.float32))),
        ("page size", dict(pool=np.zeros((3, 2, 64, 32), np.float32))),
    ]
    for match, kw in cases:
        a = dict(q=q, pool=pool, ks=None)
        a.update(kw)
        for impl in ("jax", "torch"):
            with pytest.raises(ValueError, match=match):
                if impl == "jax":
                    _jax_paged(a["q"], a["pool"], a["pool"], table, 0,
                               a["ks"], None)
                else:
                    _torch_paged(fn, a["q"], a["pool"], a["pool"], table, 0,
                                 a["ks"], None)
    # a single-page pool tolerates a short page (no indirection happens)
    one = np.zeros((1, 2, 64, 32), np.float32)
    _torch_paged(fn, q, one, one, np.zeros((1, 1), np.int32), 3)


def test_paged_cache_helpers():
    c = tgen.init_paged_cache(
        tgen.tfm.TransformerConfig(vocab_size=64, d_model=64, n_layers=2,
                                   n_heads=4, head_dim=32, n_kv_heads=2),
        5, 128, kv_dtype="int8", device="cpu")
    assert set(c) == {"layer0", "layer1"}
    assert c["layer1"]["k"].shape == (5, 2, 128, 32)
    assert c["layer1"]["k"].dtype == torch.int8
    assert c["layer1"]["vs"].shape == (5, 2, 128, 1)


PAGED_RECIPE_CASES = [(g, d, quant) for g in (1, 4) for d in (64, 128)
                      for quant in (False, True)]


@pytest.mark.parametrize(
    "g,d,quant", PAGED_RECIPE_CASES,
    ids=[f"g{g}-d{d}-{'int8' if q else 'bf16'}"
         for g, d, q in PAGED_RECIPE_CASES])
def test_paged_split_recipe_matches_jax(g, d, quant):
    """The kernel's split recipe against the Pallas paged kernel in
    interpret mode on the same bf16 inputs: 7 sequences x 4 kv heads, 4
    pages of 128 per sequence scattered over a shuffled pool whose spare
    pages hold garbage (L = 64 slots): pos at 0, 31, 32, L-1, L, L+1 and
    S-1.  The replay gathers each sequence's logical rows through its
    live table entries only, the rest of the table being poisoned."""
    b, hkv, page, n_pages = 7, 4, 128, 4
    s = page * n_pages
    split_len = tattn.decode_split_plan(b, hkv, g, s)[0]
    assert split_len == tattn.decode_split_plan(b, hkv, g, 2048)[0] == 64
    pos = np.array([0, 31, 32, split_len - 1, split_len, split_len + 1,
                    s - 1], np.int32)
    q, kc, vc, ks, vs = _bf16_case(60 + g + d, b, hkv * g, hkv, s, d, quant)
    table = (np.random.default_rng(g + d).permutation(b * n_pages) + 2) \
        .reshape(b, n_pages).astype(np.int32)

    def pool(x, fill):
        w = x.shape[-1]
        p = np.full((b * n_pages + 2, hkv, page, w), fill, x.dtype)
        p[table.reshape(-1)] = (x.reshape(b, hkv, n_pages, page, w)
                                .transpose(0, 2, 1, 3, 4)
                                .reshape(b * n_pages, hkv, page, w))
        return p

    big = 100 if quant else 1e4
    pools = [pool(kc, big), pool(vc, -big)]
    if quant:
        pools += [pool(ks, 100.0), pool(vs, 100.0)]
    jpools = [jnp.asarray(pools[0], jnp.int8 if quant else jnp.bfloat16),
              jnp.asarray(pools[1], jnp.int8 if quant else jnp.bfloat16)]
    scales = {} if not quant else dict(k_scale=jnp.asarray(pools[2]),
                                       v_scale=jnp.asarray(pools[3]))
    want = jattn.decode_attention_paged(
        jnp.asarray(q, jnp.bfloat16), *jpools,
        jnp.asarray(_poison(table, pos, page, 0)), jnp.asarray(pos),
        **scales)

    def gather(p):  # each sequence's live pages, read through the table
        view = np.zeros((b, hkv, s, p.shape[-1]), p.dtype)
        for bb, last in enumerate(pos):
            for j in range(int(last) // page + 1):
                view[bb, :, j * page:(j + 1) * page] = p[table[bb, j]]
        return view

    views = [gather(p) for p in pools] + [None] * (4 - len(pools))
    got = _recipe_decode(q[:, :, 0], views[0], views[1], pos,
                         split_len=split_len, ks=views[2], vs=views[3])
    _hold_bf16_rows(got, np.asarray(want, np.float32)[:, :, 0])


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the paged decode kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,quant,d,g", [
    (torch.float32, False, 128, 1), (torch.float32, False, 64, 4),
    (torch.bfloat16, False, 128, 1), (torch.bfloat16, True, 64, 4),
    (torch.float32, True, 128, 2)])
def test_paged_kernel_matches_plain_and_dense_kernel(cuda, qdtype, quant, d,
                                                     g):
    """K8/K9 against the plain version on a shuffled pool with poisoned
    table tails (f32 to 1e-5, bf16 to 2e-2), and BITWISE equal to the dense
    kernel K6/K7 over the same rows laid out contiguously."""
    hkv, b = 2, 3
    q, k, v, k_pool, v_pool, table = _paged_case(30, b=b, h=hkv * g,
                                                 hkv=hkv, d=d)
    pos = np.array([0, 511, 1023], np.int32)
    table = _poison(table, pos, 512, 999_999)

    def dev(x, dtype=None):
        t = torch.from_numpy(x).to(cuda)
        return t if dtype is None else t.to(dtype)

    qt = dev(q, qdtype)
    kw, dkw = {}, {}
    if quant:
        kp, kw["k_scale"] = tgen.quantize_kv(dev(k_pool))
        vp, kw["v_scale"] = tgen.quantize_kv(dev(v_pool))
        kd, dkw["k_scale"] = tgen.quantize_kv(dev(k))
        vd, dkw["v_scale"] = tgen.quantize_kv(dev(v))
    else:
        kp, vp = dev(k_pool, qdtype), dev(v_pool, qdtype)
        kd, vd = dev(k, qdtype), dev(v, qdtype)
    tt, pt = dev(table), dev(pos)
    before = tattn.decode_attention_paged.launches
    out = tattn.decode_attention_paged(qt, kp, vp, tt, pt, **kw)
    ref = tattn.decode_attention_paged_plain(qt, kp, vp, tt, pt, **kw)
    dense = tattn.decode_attention(qt, kd, vd, pt, **dkw)
    torch.cuda.synchronize()
    assert tattn.decode_attention_paged.launches == before + 1
    tol = 1e-5 if qdtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(out, dense)


@pytest.mark.cuda
def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 1, 64), device=cuda)
    pool = torch.zeros((3, 2, 136, 64), device=cuda)  # 136 % 32 != 0
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        tattn.decode_attention_paged(q, pool, pool, table, 0)
    with pytest.raises(ValueError, match="int32"):
        tattn.decode_attention_paged(q, pool[:, :, :128], pool[:, :, :128],
                                     table.long(), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,quant", [
    (torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)])
def test_paged_kernel_split_edges_on_card(cuda, qdtype, quant):
    """test_torch_attention.py's split-edge cases through 4 pages of 512
    over a shuffled pool with poisoned table tails: within chip_smoke.py's
    tolerance of the plain version, bitwise equal to the dense kernel on
    the same rows, and to itself over 51 more launches."""
    page, n_pages = 512, 4
    for i, (b, hkv, pos) in enumerate(CARD_SPLIT_CASES):
        q, kd, vd, pt, dkw = card_split_case(cuda, b, hkv, pos, qdtype,
                                             quant, seed=i)
        pids = torch.from_numpy(np.random.default_rng(i).permutation(
            b * n_pages) + 2).to(cuda)
        table = pids.reshape(b, n_pages).to(torch.int32)

        def pool(x):
            w = x.shape[-1]
            p = torch.zeros((b * n_pages + 2, hkv, page, w), dtype=x.dtype,
                            device=cuda)
            p[pids] = (x.reshape(b, hkv, n_pages, page, w).transpose(1, 2)
                       .reshape(b * n_pages, hkv, page, w))
            return p

        kw = {name: pool(t) for name, t in dkw.items()}
        kp, vp = pool(kd), pool(vd)
        tt = table.clone()
        for j, p in enumerate(pos):
            tt[j, p // page + 1:] = 999_999
        out = tattn.decode_attention_paged(q, kp, vp, tt, pt, **kw)
        ref = tattn.decode_attention_paged_plain(q, kp, vp, tt, pt, **kw)
        dense = tattn.decode_attention(q, kd, vd, pt, **dkw)
        torch.cuda.synchronize()
        assert card_agreement(out, ref), (b, hkv, pos)
        assert torch.equal(out, dense)
        assert repeats_bitwise(
            lambda: tattn.decode_attention_paged(q, kp, vp, tt, pt, **kw),
            out)
