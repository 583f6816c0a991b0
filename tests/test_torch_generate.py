"""The port's KV-cache decoding (distributed_pytorch_tpu_torch/generate.py)
against the JAX package's generate.py, on the CPU in float32.

Same model as tests/test_serve.py (vocab 256, d128, 2 layers, 4 heads of
32, 2 kv heads, d_ff 256) with the JAX ``tfm.init(jax.random.key(0))``
weights carried across by convert.py, so the JAX oracles reuse programs
the JAX suite already compiles.  Logits: atol/rtol 1e-4 (float32 on both
sides, different summation orders).  Greedy tokens: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import generate as jgen
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import generate as tgen
from distributed_pytorch_tpu_torch.models import transformer as ttfm

SHAPE = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
             head_dim=32, n_kv_heads=2, d_ff=256)
JCFG = jtfm.TransformerConfig(**SHAPE)
TCFG = ttfm.TransformerConfig(**SHAPE)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU shapes: parallel test workers
    each running torch's default thread pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init(jax.random.key(0), JCFG)
    return jp, convert.from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def test_quantize_kv_bitwise_equal_to_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 3, 17, 32)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                      # zero row: the scale floor
    x[0, 0, 1, :2] = [127.0, -63.5]       # a round-half-to-even tie
    jq, js = jgen.quantize_kv(jnp.asarray(x))
    tq, ts = tgen.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tgen.dequantize_kv(tq, ts).numpy(),
        np.asarray(jgen.dequantize_kv(jq, js)))


def test_cache_helpers_match_jax():
    for kv_dtype in (None, "int8"):
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            assert tgen.kv_bytes_per_token(TCFG, dt, kv_dtype) == \
                jgen.kv_bytes_per_token(JCFG, jdt, kv_dtype)
    for n in (1, 511, 512, 513, 2048):
        assert tgen.pad_cache_len(n) == jgen.pad_cache_len(n)
    assert tgen.canon_kv_dtype("int8") is torch.int8
    assert tgen.canon_kv_dtype(torch.int8) is torch.int8
    assert tgen.canon_kv_dtype(None) is None
    with pytest.raises(ValueError, match="kv_dtype"):
        tgen.canon_kv_dtype("fp8")
    c = tgen.init_cache(TCFG, 3, 64, kv_dtype="int8", device="cpu")
    assert c["layer1"]["k"].shape == (3, 2, 64, 32)
    assert c["layer1"]["ks"].shape == (3, 2, 64, 1)
    assert tgen.default_decode_kernel(None, "cpu") is False
    assert tgen.default_decode_kernel(None, "cuda") is True


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_forward_cached_prefill_and_decode_logits_match_jax(params,
                                                            kv_dtype):
    """Prefill logits, then every lockstep decode step's logits, against
    the JAX cache-backed forward on the same tokens.

    int8 tolerance 1e-3: a K/V element whose float32 value differs by an
    ulp between the two frameworks can round to the adjacent int8 level,
    one step of absmax/127 in that row (seen: 2.7e-4 on 1.4% of logits)."""
    tol = TOL if kv_dtype is None else dict(atol=1e-3, rtol=1e-3)
    jp, tp = params
    rng = np.random.default_rng(1)
    b, s0, steps, max_len = 2, 11, 5, 32
    prompt = rng.integers(0, 256, (b, s0)).astype(np.int32)
    feed = rng.integers(0, 256, (steps, b)).astype(np.int32)
    jc = jgen.init_cache(JCFG, b, max_len, kv_dtype=kv_dtype)
    tc = tgen.init_cache(TCFG, b, max_len, kv_dtype=kv_dtype, device="cpu")
    jl, jc = jgen._forward_cached(jp, jc, jnp.asarray(prompt),
                                  jnp.arange(s0), 0, cfg=JCFG, k_len=s0)
    tl, tc = tgen._forward_cached(tp, tc, torch.from_numpy(prompt).long(),
                                  torch.arange(s0), 0, cfg=TCFG, k_len=s0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    for t in range(steps):
        jl, jc = jgen.decode_step(jp, jc, jnp.asarray(feed[t]), s0 + t,
                                  cfg=JCFG)
        tl, tc = tgen.decode_step(tp, tc, torch.from_numpy(feed[t]).long(),
                                  s0 + t, cfg=TCFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)


def test_ragged_decode_matches_jax(params):
    """Per-sequence positions and write offsets, through the decode-kernel
    path (the plain version on CPU) on the port's side and the XLA path on
    the JAX side."""
    jp, tp = params
    rng = np.random.default_rng(2)
    b, s0, max_len = 3, 9, 32
    prompt = rng.integers(0, 256, (b, s0)).astype(np.int32)
    jc = jgen.init_cache(JCFG, b, max_len)
    tc = tgen.init_cache(TCFG, b, max_len, device="cpu")
    _, jc = jgen._forward_cached(jp, jc, jnp.asarray(prompt),
                                 jnp.arange(s0), 0, cfg=JCFG, k_len=s0)
    tgen._forward_cached(tp, tc, torch.from_numpy(prompt).long(),
                         torch.arange(s0), 0, cfg=TCFG, k_len=s0)
    pos = np.array([s0, 4, 7], np.int32)
    for t in range(3):
        tok = rng.integers(0, 256, (b,)).astype(np.int32)
        jl, jc = jgen.decode_step_ragged(jp, jc, jnp.asarray(tok),
                                         jnp.asarray(pos + t), cfg=JCFG)
        tl, _ = tgen.decode_step_ragged(
            tp, tc, torch.from_numpy(tok).long(),
            torch.from_numpy(pos + t), cfg=TCFG, use_decode_kernel=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_greedy_generate_equals_jax(params, kv_dtype):
    jp, tp = params
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, (2, 13)).astype(np.int32)
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt),
                                    jax.random.key(1), cfg=JCFG, max_new=10,
                                    temperature=0.0, decode_kernel=False,
                                    kv_dtype=kv_dtype))
    for kernel in (False, True):
        got = tgen.generate(tp, prompt, cfg=TCFG, max_new=10,
                            temperature=0.0, decode_kernel=kernel,
                            kv_dtype=kv_dtype, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_generate_eos_and_sampling(params):
    """eos: a sequence keeps emitting eos once sampled, as in JAX.
    Sampling: seeded draws reproduce, top_k=1 is greedy."""
    jp, tp = params
    prompt = np.random.default_rng(4).integers(0, 256, (2, 8)).astype(
        np.int32)
    greedy = tgen.generate(tp, prompt, cfg=TCFG, max_new=6, temperature=0.0,
                           device="cpu").numpy()
    eos = int(greedy[0, 9])
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt),
                                    jax.random.key(1), cfg=JCFG, max_new=6,
                                    temperature=0.0, eos_id=eos,
                                    decode_kernel=False))
    got = tgen.generate(tp, prompt, cfg=TCFG, max_new=6, temperature=0.0,
                        eos_id=eos, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    a = tgen.generate(tp, prompt, 5, cfg=TCFG, max_new=6, temperature=0.9,
                      top_p=0.9, device="cpu")
    b = tgen.generate(tp, prompt, 5, cfg=TCFG, max_new=6, temperature=0.9,
                      top_p=0.9, device="cpu")
    assert torch.equal(a, b)
    k1 = tgen.generate(tp, prompt, 5, cfg=TCFG, max_new=6, temperature=1.3,
                       top_k=1, device="cpu")
    np.testing.assert_array_equal(k1.numpy(), greedy)


def _logits(seed, b=4, v=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, v)).astype(np.float32)
    x[0, :3] = x[0].max() + 1.0  # a three-way tie at the top
    return x


def test_filter_per_seq_equals_jax():
    x = _logits(5)
    temp = np.array([0.0, 0.7, 1.0, 2.0], np.float32)
    top_k = np.array([0, 5, 64, 3], np.int32)
    top_p = np.array([1.0, 0.9, 0.3, 0.0], np.float32)
    want = np.asarray(jgen.filter_per_seq(jnp.asarray(x), jnp.asarray(temp),
                                          jnp.asarray(top_k),
                                          jnp.asarray(top_p)))
    got = tgen.filter_per_seq(torch.from_numpy(x), torch.from_numpy(temp),
                              torch.from_numpy(top_k), torch.from_numpy(top_p))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert ((got.numpy() == tgen.NEG_INF) == (want == jgen.NEG_INF)).all()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.8, 5, None), (1.5, None, 0.5), (0.5, 10, 0.8)])
def test_filter_logits_equals_jax(temperature, top_k, top_p):
    x = _logits(6)
    want = np.asarray(jgen._filter_logits(jnp.asarray(x), temperature,
                                          top_k, top_p))
    got = tgen._filter_logits(torch.from_numpy(x), temperature, top_k, top_p)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_sampling_greedy_rows_take_first_max():
    """argmax takes the first maximal index (jnp.argmax's rule); rows with
    temperature <= 0 are greedy whatever the draw."""
    x = torch.from_numpy(_logits(7))
    toks = tgen.sample_per_seq(torch.Generator().manual_seed(0), x,
                               torch.tensor([0.0, 0.0, 1.0, 1.0]),
                               torch.zeros(4, dtype=torch.int32),
                               torch.ones(4))
    assert int(toks[0]) == 0
    assert int(toks[1]) == int(np.argmax(x[1].numpy()))
    assert tgen._sample(None, x, 0.0, None).tolist() == \
        np.argmax(x.numpy(), -1).tolist()


def test_unported_modes_are_refused(params):
    _, tp = params
    c = tgen.init_cache(TCFG, 2, 16, device="cpu")
    tok = torch.zeros((2, 3), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tgen.decode_step(tp, c, tok[:, 0], 0, cfg=TCFG, tp_axis="model")
    with pytest.raises(ValueError, match="k_len"):
        tgen.decode_step(tp, c, tok[:, 0], 0, cfg=TCFG, k_len=4,
                         use_decode_kernel=True)


# -- the paged pool and the multi-token ragged window ----------------------

PAGE = 128


def _pool_case(seed, kv_dtype=None, n_pages=7, b=3):
    """A JAX (P, Hkv, PAGE, Dh) pool pair filled with seeded noise (int8:
    the JAX quantizer's values and scales) and a shuffled (B, 2) table
    over pages 1.. (page 0 stays scratch)."""
    rng = np.random.default_rng(seed)
    shape = (n_pages, 2, PAGE, 32)
    pool = {}
    for i in range(TCFG.n_layers):
        kv = {n: jnp.asarray(rng.standard_normal(shape), jnp.float32)
              for n in ("k", "v")}
        if kv_dtype is not None:
            kq, ks = jgen.quantize_kv(kv["k"])
            vq, vs = jgen.quantize_kv(kv["v"])
            kv = {"k": kq, "v": vq, "ks": ks, "vs": vs}
        pool[f"layer{i}"] = kv
    table = (rng.permutation(n_pages - 1)[:2 * b] + 1).astype(
        np.int32).reshape(b, 2)
    return pool, table


def _leaves_close(tc, jc, skip=None, tol=None):
    """Every leaf of the port's cache against the JAX one; ``skip`` is an
    index expression of rows whose contents may differ (colliding clamped
    writes, resolved arbitrarily on both sides)."""
    for name, layer in jc.items():
        for leaf, ja in layer.items():
            want = np.array(ja)
            got = tc[name][leaf].numpy()
            if skip is not None:
                want[skip] = got[skip] = 0
            if want.dtype == np.int8:  # one quantization level at most
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, **(tol or TOL))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_single_token_decode_matches_jax(params, kv_dtype):
    """One ragged decode step through a block table: the new K/V row of
    sequence b lands in pool page table[b, pos // PAGE] at row pos % PAGE
    on both sides, and attention reads through the table (the JAX Pallas
    paged kernel in interpret mode; the port's plain paged version).
    f32: logits within 1e-5 abs + rel and the written pool leaves equal to
    1e-5.  int8: logits to 1e-3 and leaves within one quantization level
    (the int8 note of the prefill test above)."""
    jp, tp = params
    tol = (dict(atol=1e-5, rtol=1e-5) if kv_dtype is None
           else dict(atol=1e-3, rtol=1e-3))
    jpool, table = _pool_case(5, kv_dtype)
    tpool = convert.from_jax_cache(jpool, device="cpu")
    rng = np.random.default_rng(6)
    tok = rng.integers(0, 256, (3,)).astype(np.int32)
    pos = np.array([5, 130, 255], np.int32)  # page 0, page 1, the last row
    jl, jpool = jgen.decode_step_ragged(
        jp, jpool, jnp.asarray(tok), jnp.asarray(pos), cfg=JCFG,
        use_decode_kernel=True, page_table=jnp.asarray(table))
    tl, tpool = tgen.decode_step_ragged(
        tp, tpool, torch.from_numpy(tok).long(), torch.from_numpy(pos),
        cfg=TCFG, use_decode_kernel=True,
        page_table=torch.from_numpy(table))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    _leaves_close(tpool, jpool, tol=dict(atol=1e-5, rtol=1e-5))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_multi_token_window_matches_jax(params, paged):
    """``verify_step_ragged``: a (B, W) window at per-sequence positions,
    each token written at its own (B, W) ``write_pos`` in one scatter,
    through the table when paged, with a ``k_len`` live-depth hint, and
    with the last tokens of each row clamped onto one duplicate write row
    (the suffix prefill's pad clamp).  Logits of the rows below the clamp
    (the only ones whose reads are defined) within 1e-5 abs + rel; every
    cache row but the colliding ones equal to 1e-5."""
    jp, tp = params
    rng = np.random.default_rng(7)
    b, w = 3, 6
    base = np.array([0, 100, 190], np.int32)
    pos = base[:, None] + np.arange(w, dtype=np.int32)[None]
    wcap = base + 3                       # tokens 3..5 all write row base+3
    write_pos = np.minimum(pos, wcap[:, None])
    tokens = rng.integers(0, 256, (b, w)).astype(np.int32)
    if paged:
        jc, table = _pool_case(8)
        kw = dict(page_table=table, k_len=200)
    else:
        jc = jgen.init_cache(JCFG, b, 256)
        jc = {n: {k: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
                  for k, a in layer.items()} for n, layer in jc.items()}
        kw = dict(k_len=200)
    tc = convert.from_jax_cache(jc, device="cpu")
    jkw = {k: jnp.asarray(v) if k == "page_table" else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if k == "page_table" else v
           for k, v in kw.items()}
    jl, jc = jgen.verify_step_ragged(jp, jc, jnp.asarray(tokens),
                                     jnp.asarray(pos), jnp.asarray(write_pos),
                                     cfg=JCFG, **jkw)
    tl, tc = tgen.verify_step_ragged(tp, tc, torch.from_numpy(tokens).long(),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(write_pos), cfg=TCFG,
                                     **tkw)
    assert tl.shape == (b, w, 256)
    ok = pos < wcap[:, None]
    np.testing.assert_allclose(tl.numpy()[ok], np.asarray(jl)[ok],
                               atol=1e-5, rtol=1e-5)
    if paged:
        rows = table[np.arange(b), wcap // PAGE], slice(None), wcap % PAGE
    else:
        rows = np.arange(b), slice(None), wcap
    _leaves_close(tc, jc, skip=rows, tol=dict(atol=1e-5, rtol=1e-5))


def test_paged_guards_match_jax(params):
    """The JAX guards: a page table needs ragged positions and, for
    single-token decode, the kernel path; a paged multi-token window needs
    (B, S) per-token write positions."""
    _, tp = params
    pool = tgen.init_paged_cache(TCFG, 3, PAGE, device="cpu")
    table = torch.ones((2, 1), dtype=torch.int32)
    tok = torch.zeros((2, 3), dtype=torch.long)
    with pytest.raises(ValueError, match="kernel path"):
        tgen.decode_step_ragged(tp, pool, tok[:, 0], torch.zeros(2),
                                cfg=TCFG, page_table=table)
    with pytest.raises(ValueError, match="ragged"):
        tgen._forward_cached(tp, pool, tok[:, :1], torch.zeros(1), 0,
                             cfg=TCFG, use_decode_kernel=True,
                             page_table=table)
    with pytest.raises(ValueError, match=r"\(B, S\)"):
        tgen.verify_step_ragged(tp, pool, tok, torch.zeros((2, 3)),
                                torch.zeros(2), cfg=TCFG, page_table=table)
