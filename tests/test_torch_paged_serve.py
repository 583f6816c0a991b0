"""The port's paged continuous batcher (distributed_pytorch_tpu_torch/
serve.py, ``paged=True``: page pool, preemption by host-swap, prefix
caching, drained-tail compaction) against the JAX package, on the CPU in
float32.

Oracle: the JAX static ``generate()`` at temperature 0 through its decode
kernel (interpret mode), as tests/test_serve.py calls it for its paged
tests, on the same model, weights and prompts.  Greedy tokens must match
exactly.  Each test mirrors the JAX serving test of the same name, with its
prompts and budgets where its assertions depend on them.  One test runs the
JAX batcher itself beside the port's (scheduler parity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import generate as jgen
from distributed_pytorch_tpu import serve as jserve
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import generate as tgen
from distributed_pytorch_tpu_torch import serve as tserve
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from distributed_pytorch_tpu_torch.ops import attention as tattn

SHAPE = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
             head_dim=32, n_kv_heads=2, d_ff=256)
JCFG = jtfm.TransformerConfig(**SHAPE)
TCFG = ttfm.TransformerConfig(**SHAPE)


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


_ORACLE: dict = {}


def _oracle(jp, prompt, max_new, kv_dtype=None):
    """The JAX oracle, computed once per (params, prompt, budget, kv
    dtype): tests that drive several batchers over one load reuse it."""
    key = (id(jp), np.asarray(prompt, np.int32).tobytes(), max_new, kv_dtype)
    if key not in _ORACLE:
        _ORACLE[key] = np.asarray(jgen.generate(
            jp, jnp.asarray(prompt)[None], jax.random.key(1), cfg=JCFG,
            max_new=max_new, temperature=0.0, decode_kernel=True,
            kv_dtype=kv_dtype))[0]
    return _ORACLE[key]


def _batcher(tp, **kw):
    kw.setdefault("max_len", 1024)
    kw.setdefault("paged", True)
    return tserve.ContinuousBatcher(tp, TCFG, temperature=0.0,
                                    device="cpu", **kw)


def _drive(cb, prompts, budgets):
    rids = [cb.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
    while cb.pending():
        cb.step()
    return rids


def _assert_exact(jp, cb, rids, prompts, budgets, **kw):
    for rid, p, b in zip(rids, prompts, budgets):
        np.testing.assert_array_equal(cb.result(rid), _oracle(jp, p, b, **kw))


def _assert_drained(cb):
    assert len(cb.free_pages) == cb.pool_pages - 1
    assert all(not p for p in cb.slot_pages)
    assert not cb.swapped
    assert (cb.table == 0).all()


def test_paged_kv_pool_matches_oracle(params):
    """Ragged requests through a page pool with recycling stay
    oracle-exact, each decode step goes through the paged decode (never
    the dense one), and the pool drains clean."""
    jp, tp = params
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, 256, (L,)).astype(np.int32)
               for L in (5, 17, 40, 9, 23)]
    cb = _batcher(tp, slots=2, prompt_buckets=(32, 64), decode_kernel=True)
    assert cb.pool_pages == 2 * (1024 // 512) + 1  # + scratch
    dense0 = tattn.decode_attention.launches
    _assert_exact(jp, cb, _drive(cb, prompts, [10] * 5), prompts, [10] * 5)
    _assert_drained(cb)
    assert tattn.decode_attention.launches == dense0
    assert cb.stats["emitted_tokens"] == 50


def test_paged_pool_oversubscription(params):
    """A pool smaller than slots x max_len serves short sequences without
    pressure; when two live sequences must both cross a page boundary on a
    2-page pool, the youngest is preempted (host-swap) and resumed, and
    both land oracle-exact."""
    jp, tp = params
    rng = np.random.default_rng(16)
    p = rng.integers(0, 256, (8,)).astype(np.int32)
    cb = _batcher(tp, slots=2, prompt_buckets=(32,), pool_pages=3,
                  decode_kernel=True)
    rids = _drive(cb, [p, p], [8, 8])
    assert [len(cb.result(r)) for r in rids] == [16, 16]
    assert cb.stats["evictions"] == 0

    prompts = [rng.integers(0, 256, (500,)).astype(np.int32)
               for _ in range(2)]
    cb2 = _batcher(tp, slots=2, prompt_buckets=(512,), pool_pages=3,
                   decode_kernel=True)
    _assert_exact(jp, cb2, _drive(cb2, prompts, [80, 80]), prompts, [80, 80])
    assert cb2.stats["evictions"] >= 1, cb2.stats
    assert cb2.stats["swap_ins"] == cb2.stats["evictions"], cb2.stats
    _assert_drained(cb2)


def test_preemption_resumes_past_prompt_buckets(params):
    """Host-swap instead of re-prefill: victims whose prompt + generated
    prefix exceeds every prompt bucket resume exactly."""
    jp, tp = params
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, 256, (L,)).astype(np.int32)
               for L in (40, 60, 30)]
    budgets = [700, 650, 600]    # all cross the 512-page boundary
    cb = _batcher(tp, slots=2, prompt_buckets=(64,), pool_pages=4,
                  decode_kernel=True, steps_per_sync=64)
    _assert_exact(jp, cb, _drive(cb, prompts, budgets), prompts, budgets)
    assert cb.stats["evictions"] >= 1, cb.stats
    _assert_drained(cb)


def test_preemption_with_non_power_of_two_pages_per_slot(params):
    """max_len 1536 (3 pages per slot): a victim owning all 3 pages is
    gathered to the host and scattered back exactly (the port moves
    exactly the owned pages, no power-of-two padding)."""
    jp, tp = params
    rng = np.random.default_rng(26)
    prompts = [rng.integers(0, 256, (L,)).astype(np.int32) for L in (20, 25)]
    cb = _batcher(tp, slots=2, max_len=1536, prompt_buckets=(32,),
                  pool_pages=4, decode_kernel=True, steps_per_sync=64)
    _assert_exact(jp, cb, _drive(cb, prompts, [1100, 1100]), prompts,
                  [1100, 1100])
    assert cb.stats["evictions"] >= 1, cb.stats
    _assert_drained(cb)


def test_paged_prealloc_respects_budget(params):
    """Pre-allocation covers pos + min(steps_per_sync, budget) only: two
    ~505-token prompts with budget 4 fit one page each on a 2-page pool
    (a full 32-step block would need a second page per slot)."""
    jp, tp = params
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, 256, (505,)).astype(np.int32)
               for _ in range(2)]
    cb = _batcher(tp, slots=2, prompt_buckets=(512,), pool_pages=3,
                  decode_kernel=True, steps_per_sync=32)
    _assert_exact(jp, cb, _drive(cb, prompts, [4, 4]), prompts, [4, 4])
    assert cb.stats["evictions"] == 0
    assert len(cb.free_pages) == 2


def test_paged_validation(params):
    _, tp = params
    with pytest.raises(ValueError, match="decode-kernel"):
        _batcher(tp, decode_kernel=False)
    with pytest.raises(ValueError, match="cannot hold"):
        _batcher(tp, pool_pages=2, decode_kernel=True)
    with pytest.raises(ValueError, match="requires paged=True"):
        _batcher(tp, paged=False, prefix_cache=True)
    with pytest.raises(ValueError, match="prefill_chunk"):
        _batcher(tp, prefix_cache=True, prefill_chunk=16)
    # pool_pages without paged is ignored, as in the JAX batcher
    cb = _batcher(tp, paged=False, pool_pages=2)
    assert not cb.paged and cb.cache["layer0"]["k"].shape[0] == 4
    # the paged pool's shapes, and the default pool
    cb = _batcher(tp, slots=3)
    assert cb.pool_pages == 3 * 2 + 1 and cb.use_kernel
    assert cb.cache["layer1"]["k"].shape == (7, 2, 512, 32)
    assert cb.table.shape == (3, 2) and list(cb.free_pages) == [1, 2, 3, 4,
                                                                5, 6]


def test_paged_freed_slot_writes_cannot_corrupt_recycled_pages(params):
    """A retired slot keeps lockstep-writing in later blocks: its table row
    points at the scratch page once its pages are recycled.  The long
    request crosses 512 and acquires the short one's freed page; it stays
    oracle-exact."""
    jp, tp = params
    rng = np.random.default_rng(17)
    p_short = rng.integers(0, 256, (6,)).astype(np.int32)
    p_long = rng.integers(0, 256, (480,)).astype(np.int32)
    cb = _batcher(tp, slots=2, prompt_buckets=(32, 512), pool_pages=3,
                  decode_kernel=True, steps_per_sync=8)
    prompts, budgets = [p_long, p_short], [80, 4]
    _assert_exact(jp, cb, _drive(cb, prompts, budgets), prompts, budgets)
    assert len(cb.free_pages) == 2


def test_paged_allocates_by_prompt_length_not_bucket(params):
    """A short prompt in a wide bucket holds only ceil(L / page) pages."""
    _, tp = params
    rng = np.random.default_rng(18)
    cb = _batcher(tp, slots=1, prompt_buckets=(1024,), decode_kernel=True)
    r = cb.submit(rng.integers(0, 256, (5,)).astype(np.int32), max_new=20)
    cb.step()
    assert len(cb.slot_pages[0]) == 1, cb.slot_pages
    while cb.pending():
        cb.step()
    assert len(cb.result(r)) == 25


def test_drained_tail_batch_compaction(params):
    """Once the queue drains, paged blocks run over just the live rows:
    exact, pages recycled, compact dispatches counted, utilization above
    the dense batcher's on the same load; compact_tail=False keeps every
    block full width.  On the serial path (in-block refill and overlap
    off), where every step the device runs is a counted slot-step."""
    jp, tp = params
    rng = np.random.default_rng(27)
    prompts = [rng.integers(0, 256, (L,)).astype(np.int32)
               for L in (5, 17, 9, 23)]
    budgets = [4, 6, 8, 40]   # one long request left alone at the tail
    kw = dict(slots=4, prompt_buckets=(32,), steps_per_sync=8,
              inblock_refill=False, overlap=False)
    cb = _batcher(tp, decode_kernel=True, **kw)
    _assert_exact(jp, cb, _drive(cb, prompts, budgets), prompts, budgets)
    assert cb.stats["compact_dispatches"] >= 2, cb.stats
    _assert_drained(cb)
    cb_d = _batcher(tp, paged=False, **kw)
    _drive(cb_d, prompts, budgets)
    assert cb_d.stats["compact_dispatches"] == 0
    assert cb.utilization() > cb_d.utilization()
    cb_o = _batcher(tp, decode_kernel=True, compact_tail=False, **kw)
    _assert_exact(jp, cb_o, _drive(cb_o, prompts, budgets), prompts,
                  budgets)
    assert cb_o.stats["compact_dispatches"] == 0
    assert cb_o.stats["slot_steps"] == 4 * cb_o.stats["decode_steps"]


def test_prefix_cache_shared_prompt_workload(params):
    """Four requests sharing a >1-page system prompt admit over the SAME
    cached page (one full prefill, then suffix prefills), stay
    oracle-exact, and the registry persists across retirements: a second
    wave is all hits.  The counts are the JAX test's (3 hits and 3 shared
    pages, then 7 hits)."""
    jp, tp = params
    rng = np.random.default_rng(0)
    sysp = rng.integers(0, 64, (520,)).astype(np.int32)
    prompts = [np.concatenate([sysp,
                               rng.integers(0, 64, (6,)).astype(np.int32)])
               for _ in range(4)]
    cb = _batcher(tp, slots=2, steps_per_sync=4, prompt_buckets=(32, 1024),
                  prefix_cache=True)
    _assert_exact(jp, cb, _drive(cb, prompts, [6] * 4), prompts, [6] * 4)
    s = cb.stats
    assert s["prefix_hits"] == 3 and s["prefix_pages_shared"] == 3, s
    assert s["prefill_dispatches"] == 4
    assert len(cb.registry) == 1
    pid = next(iter(cb.registry.values()))
    assert cb.page_refs[pid] == 0  # all retired; cached for the future
    _assert_exact(jp, cb, _drive(cb, prompts, [6] * 4), prompts, [6] * 4)
    assert cb.stats["prefix_hits"] == 7, cb.stats


def test_prefix_cache_reclaim_under_pressure(params):
    """Cached prefixes yield to live work: distinct registered pages are
    reclaimed LRU when the free list runs dry, instead of preempting or
    failing admissions, and the streams stay exact."""
    jp, tp = params
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, (513,)).astype(np.int32)
               for _ in range(4)]  # 4 DISTINCT 1-full-page prefixes
    cb = _batcher(tp, slots=2, steps_per_sync=4, prompt_buckets=(32, 1024),
                  prefix_cache=True, pool_pages=6)
    _assert_exact(jp, cb, _drive(cb, prompts, [4] * 4), prompts, [4] * 4)
    s = cb.stats
    assert s["prefix_reclaimed"] > 0, s
    assert s["evictions"] == 0, s
    assert len(cb.registry) + len(cb.free_pages) == cb.pool_pages - 1


def test_serving_paged_int8_matches_oracle(params):
    """The int8 pool with slot recycling equals static int8 generation:
    quantized writes land at the right rows, scale pages follow the block
    tables, recycled slots' stale scales never leak."""
    jp, tp = params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (L,)).astype(np.int32)
               for L in (5, 17, 40, 9, 23)]
    cb = _batcher(tp, slots=2, max_len=512, prompt_buckets=(32, 64),
                  kv_dtype="int8", steps_per_sync=4)
    assert cb.cache["layer0"]["ks"].shape == (3, 2, 512, 1)
    _assert_exact(jp, cb, _drive(cb, prompts, [10] * 5), prompts, [10] * 5,
                  kv_dtype="int8")
    _assert_drained(cb)


def test_scheduler_parity_with_jax_batcher(params):
    """The JAX batcher itself (paged, pool_pages=3, in-block refill and
    overlap off, the decode kernel on) and the port's on the same
    oversubscribed load: the same tokens, and the same evictions,
    swap-ins, compact dispatches and decode dispatches."""
    jp, tp = params
    rng = np.random.default_rng(16)
    rng.integers(0, 256, (8,))
    prompts = [rng.integers(0, 256, (500,)).astype(np.int32)
               for _ in range(2)]
    kw = dict(slots=2, max_len=1024, temperature=0.0, prompt_buckets=(512,),
              paged=True, pool_pages=3, decode_kernel=True,
              inblock_refill=False, overlap=False)
    jcb = jserve.ContinuousBatcher(jp, JCFG, **kw)
    tcb = tserve.ContinuousBatcher(tp, TCFG, device="cpu", **kw)
    for cb in (jcb, tcb):
        _drive(cb, prompts, [80, 80])
    for rid in range(2):
        np.testing.assert_array_equal(tcb.result(rid), jcb.result(rid))
    keys = ("evictions", "swap_ins", "compact_dispatches",
            "decode_dispatches", "emitted_tokens", "prefill_dispatches")
    assert {k: tcb.stats[k] for k in keys} == \
        {k: jcb.stats[k] for k in keys}
    assert tcb.stats["evictions"] >= 1


@pytest.mark.parametrize("page", [4, 16, 512])
def test_prefix_page_hashes_equal_jax(page):
    rng = np.random.default_rng(page)
    for n in (0, page - 1, page, 3 * page + 5):
        prompt = rng.integers(0, 32000, (n,)).astype(np.int32)
        got = tserve.prefix_page_hashes(prompt, page)
        assert got == jserve.prefix_page_hashes(prompt, page)
        assert len(got) == n // page
    # a list of Python ints hashes as its int32 array
    assert tserve.prefix_page_hashes([1, 2, 3, 4], 2) == \
        jserve.prefix_page_hashes(np.asarray([1, 2, 3, 4], np.int32), 2)


def test_paged_refusals_name_their_slice(params):
    _, tp = params
    with pytest.raises(NotImplementedError, match="slice 5"):
        _batcher(tp, mesh=object())
    assert tgen.init_paged_cache(TCFG, 2, 512, device="cpu")[
        "layer0"]["v"].shape == (2, 2, 512, 32)
