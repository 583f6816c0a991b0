"""The port's paged decode attention (distributed_pytorch_tpu_torch/ops/
attention.py ``decode_attention_paged_plain`` / ``decode_attention_paged``)
against the JAX package's Pallas ``decode_attention_paged``, which runs in
interpret mode on the CPU as tests/test_attention.py runs it.

Inputs are made with numpy from a seed.  float32 on both sides, atol/rtol
2e-5 (summation order differs).  The CUDA kernels K8/K9 are checked on the
card by the ``cuda``-marked tests at the end, which skip without a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import generate as jgen
from distributed_pytorch_tpu.ops import attention as jattn
from distributed_pytorch_tpu_torch import generate as tgen
from distributed_pytorch_tpu_torch.ops import attention as tattn

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
