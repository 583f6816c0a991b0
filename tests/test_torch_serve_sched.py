"""The port's serving scheduler at the JAX batcher's defaults (in-block
refill and overlapped dispatch on) and with chunked prefill, against the
JAX package, on the CPU in float32.

Two oracles, as in tests/test_torch_paged_serve.py: the JAX static
``generate()`` at temperature 0 (greedy tokens must match exactly,
whatever slot, block or handoff served a request), and the JAX batcher
itself on the same knobs and load (the same tokens, and the same
scheduling counts: dispatches, slot-steps, admissions, in-block prefill
steps, refills, chained dispatches, waste, evictions, swap-ins and
compactions).  The model, weights (carried by convert.py), prompts and
knobs are those of tests/test_serve.py, so the JAX programs are the ones
its suite compiles.
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
from distributed_pytorch_tpu_torch import serve as tserve
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from distributed_pytorch_tpu_torch.ops import attention as tattn

SHAPE = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
             head_dim=32, n_kv_heads=2, d_ff=256)
JCFG = jtfm.TransformerConfig(**SHAPE)
TCFG = ttfm.TransformerConfig(**SHAPE)

# the scheduling counts the JAX batcher and the port's must agree on
PARITY_KEYS = ("decode_dispatches", "slot_steps", "emitted_tokens",
               "batch_admissions", "prefill_dispatches",
               "inblock_prefill_steps", "inblock_refills",
               "chained_dispatches", "wasted_slot_steps", "evictions",
               "swap_ins", "compact_dispatches")


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


def _oracle(jp, prompt, max_new, kernel=False, cfg=JCFG):
    """The JAX greedy oracle (its XLA decode path, or its decode kernel in
    interpret mode for paged loads, as tests/test_serve.py calls it),
    computed once per (prompt, budget, path)."""
    key = (id(jp), id(cfg), np.asarray(prompt, np.int32).tobytes(), max_new,
           kernel)
    if key not in _ORACLE:
        _ORACLE[key] = np.asarray(jgen.generate(
            jp, jnp.asarray(prompt)[None], jax.random.key(1), cfg=cfg,
            max_new=max_new, temperature=0.0, decode_kernel=kernel))[0]
    return _ORACLE[key]


def _port(tp, **kw):
    kw.setdefault("temperature", 0.0)
    return tserve.ContinuousBatcher(tp, TCFG, device="cpu", **kw)


def _drive(cb, prompts, budgets):
    rids = [cb.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
    while cb.pending():
        cb.step()
    return rids


def _assert_exact(jp, cb, rids, prompts, budgets, kernel=False):
    for rid, p, b in zip(rids, prompts, budgets):
        np.testing.assert_array_equal(cb.result(rid),
                                      _oracle(jp, p, b, kernel))


def _ragged_workload(seed, n, lens=(5, 17, 40, 9, 23)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def _refill_workload():
    """tests/test_serve.py's in-block refill load: ragged budgets, so
    occupants retire mid-block and hand over."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 256, (L,)).astype(np.int32)
               for L in (5, 17, 40, 9, 23, 12, 31, 7)]
    return prompts, [3, 25, 7, 18, 4, 30, 9, 5]


def _oversubscribed_workload():
    """Two 500-token prompts that both cross page 0's boundary on a
    2-page pool: one is preempted and swapped back in."""
    rng = np.random.default_rng(16)
    rng.integers(0, 256, (8,))
    return ([rng.integers(0, 256, (500,)).astype(np.int32)
             for _ in range(2)], [80, 80])


PARITY = {
    "dense": (_refill_workload, dict(max_len=512, prompt_buckets=(32, 64),
                                     steps_per_sync=16)),
    "paged": (_refill_workload, dict(max_len=1024, prompt_buckets=(32, 64),
                                     steps_per_sync=16, paged=True,
                                     decode_kernel=True)),
    "paged_pool3": (_oversubscribed_workload,
                    dict(max_len=1024, prompt_buckets=(512,), paged=True,
                         pool_pages=3, decode_kernel=True)),
    "longest_first": (_refill_workload,
                      dict(max_len=512, prompt_buckets=(32, 64),
                           steps_per_sync=8, schedule="longest_first")),
}


@pytest.mark.parametrize("setup", list(PARITY))
def test_default_scheduler_parity_with_jax_batcher(params, setup):
    """The JAX batcher at its defaults (in-block refill and overlap on) and
    the port's at its own, same knobs and load: the same greedy tokens,
    equal to static generate(), and the same scheduling counts."""
    jp, tp = params
    load, kw = PARITY[setup]
    prompts, budgets = load()
    kw = dict(slots=2, temperature=0.0, **kw)
    jcb = jserve.ContinuousBatcher(jp, JCFG, **kw)
    tcb = tserve.ContinuousBatcher(tp, TCFG, device="cpu", **kw)
    assert tcb.inblock_refill and tcb.overlap
    rids = [_drive(cb, prompts, budgets) for cb in (jcb, tcb)][1]
    for rid in rids:
        np.testing.assert_array_equal(tcb.result(rid), jcb.result(rid))
    _assert_exact(jp, tcb, rids, prompts, budgets,
                  kernel=kw.get("paged", False))
    assert {k: tcb.stats[k] for k in PARITY_KEYS} == \
        {k: jcb.stats[k] for k in PARITY_KEYS}
    if setup == "paged_pool3":
        assert tcb.stats["evictions"] >= 1
        assert tcb.stats["swap_ins"] == tcb.stats["evictions"]
    else:
        assert tcb.stats["inblock_refills"] >= 2, tcb.stats
    assert not tcb.pending() and tcb._inflight is None


# -- overlapped dispatch ----------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(paged=True),
                                dict(schedule="longest_first")],
                         ids=["dense", "paged", "longest_first"])
def test_overlap_oracle_exact(params, kw):
    """Overlapped dispatch (blocks chained from the device carry, parsed a
    step later) emits exactly the static greedy streams across slot
    recycling, refill handoffs riding chained blocks, dense and paged
    pools, and the pipeline actually chained."""
    jp, tp = params
    prompts = _ragged_workload(30, 5)
    cb = _port(tp, slots=2, max_len=512, prompt_buckets=(32, 64),
               steps_per_sync=8, overlap=True, **kw)
    rids = _drive(cb, prompts, [24] * 5)
    assert cb.stats["chained_dispatches"] > 0, cb.stats
    _assert_exact(jp, cb, rids, prompts, [24] * 5,
                  kernel=kw.get("paged", False))


def test_overlap_interleaved_submission_exact(params):
    """A submission landing while a chained block is in flight comes out
    exact: the chain breaks for its admission at the next eligible
    step."""
    jp, tp = params
    rng = np.random.default_rng(31)
    pa = rng.integers(0, 256, (6,)).astype(np.int32)
    pb = rng.integers(0, 256, (14,)).astype(np.int32)
    cb = _port(tp, slots=2, max_len=512, prompt_buckets=(32,),
               steps_per_sync=4, overlap=True)
    ra = cb.submit(pa, max_new=20)
    cb.step()
    cb.step()
    rb = cb.submit(pb, max_new=10)  # lands mid-pipeline
    while cb.pending():
        cb.step()
    np.testing.assert_array_equal(cb.result(ra), _oracle(jp, pa, 20))
    np.testing.assert_array_equal(cb.result(rb), _oracle(jp, pb, 10))


def test_overlap_eos_mid_chain_exact(params):
    """An armed eos firing inside a chained block retires the request
    exactly (the slot idles out the chain, the parsed retirement breaks
    it): the stream equals the serial run's and stops at the eos."""
    jp, tp = params
    rng = np.random.default_rng(32)
    p = rng.integers(0, 256, (8,)).astype(np.int32)
    oracle = _oracle(jp, p, 40)
    eos = int(oracle[len(p) + 9])  # fires a few blocks in
    first_hit = next(i for i in range(40) if int(oracle[len(p) + i]) == eos)

    def run(overlap):
        cb = _port(tp, slots=2, max_len=512, prompt_buckets=(32,),
                   steps_per_sync=4, overlap=overlap)
        r = cb.submit(p, max_new=40, eos_id=eos)
        while cb.pending():
            cb.step()
        return cb.result(r)

    out_on, out_off = run(True), run(False)
    np.testing.assert_array_equal(out_on, out_off)
    assert out_on[-1] == eos and len(out_on) == len(p) + first_hit + 1


def test_overlap_accounting_matches_serial(params):
    """On a pure-decode load (budgets >> K) the overlapped pipeline runs
    the identical block sequence: the same tokens and accounting as the
    serial run, chained_dispatches > 0 with overlap and 0 without, and
    the slot-step identity.  decode_steps, the steps the device ran, is
    the serial count plus at most one step per block that exited
    early."""
    _, tp = params
    prompts = _ragged_workload(33, 2, lens=(7, 11))

    def run(overlap):
        cb = _port(tp, slots=2, max_len=512, prompt_buckets=(32,),
                   steps_per_sync=4, overlap=overlap)
        return cb, cb.run(prompts, max_new=30)

    (cb_on, r_on), (cb_off, r_off) = run(True), run(False)
    for rid in r_off:
        np.testing.assert_array_equal(r_on[rid], r_off[rid])
    for key in ("decode_dispatches", "slot_steps", "emitted_tokens",
                "inblock_prefill_steps", "wasted_slot_steps",
                "batch_admissions", "prefill_dispatches"):
        assert cb_on.stats[key] == cb_off.stats[key], (
            key, cb_on.stats, cb_off.stats)
    assert cb_on.stats["chained_dispatches"] > 0
    assert cb_off.stats["chained_dispatches"] == 0
    s = cb_on.stats
    assert s["slot_steps"] == (s["emitted_tokens"] - s["batch_admissions"]
                               + s["inblock_prefill_steps"]
                               + s["wasted_slot_steps"]), s
    assert cb_off.stats["slot_steps"] == 2 * cb_off.stats["decode_steps"]
    assert 0 <= s["decode_steps"] - cb_off.stats["decode_steps"] \
        <= s["decode_dispatches"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_overlap_sampled_streams_equal_serial(params, paged):
    """A seeded temperature=0.8 load gives bitwise the same tokens with
    overlap on and off: a chained block draws from the generator exactly
    as the serially planned one would (a sampled block draws its
    uniforms for every step up front, whatever step it exits at), and
    the pipeline chained."""
    _, tp = params
    prompts = _ragged_workload(34, 3, lens=(6, 13, 9))
    budgets = [30, 22, 26]

    def run(overlap):
        cb = tserve.ContinuousBatcher(
            tp, TCFG, slots=3, max_len=1024 if paged else 512,
            temperature=0.8, top_k=40, prompt_buckets=(32,),
            steps_per_sync=4, overlap=overlap, paged=paged, seed=7,
            device="cpu")
        rids = _drive(cb, prompts, budgets)
        return cb, [cb.result(r) for r in rids]

    (cb_on, on), (cb_off, off) = run(True), run(False)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    assert cb_on.stats["chained_dispatches"] > 0, cb_on.stats
    assert [len(t) for t in on] == [len(p) + b
                                    for p, b in zip(prompts, budgets)]


def test_flush_inflight_drains_the_pipeline(params):
    """``_flush_inflight`` parses the in-flight block at once: its
    emissions land in the requests and are returned, and nothing is left
    in flight."""
    jp, tp = params
    prompts = _ragged_workload(35, 2, lens=(6, 10))
    cb = _port(tp, slots=2, max_len=512, prompt_buckets=(32,),
               steps_per_sync=4)
    rids = [cb.submit(p, max_new=12) for p in prompts]
    got = cb.step()           # admits (first tokens); the block is in flight
    assert cb._inflight is not None
    assert len(got) == 2
    flushed = cb._flush_inflight()
    assert cb._inflight is None and len(flushed) == 2 * 4
    assert [len(cb.requests[r].emitted) for r in rids] == [5, 5]
    while cb.pending():
        cb.step()
    _assert_exact(jp, cb, rids, prompts, [12, 12])


# -- in-block refill --------------------------------------------------------

def test_inblock_refill_handoff_exact_and_utilized(params):
    """Slots retiring mid-block hand over to the next queued request in
    place (teacher-forced prefill through the ragged decode step):
    oracle-exact through several handoffs, refills happen, and
    utilization beats the same load with refill off."""
    jp, tp = params
    prompts, budgets = _refill_workload()

    def serve(**kw):
        cb = _port(tp, slots=2, max_len=512, prompt_buckets=(32, 64),
                   steps_per_sync=16, **kw)
        return cb, _drive(cb, prompts, budgets)

    cb, rids = serve()
    _assert_exact(jp, cb, rids, prompts, budgets)
    assert cb.stats["inblock_refills"] >= 3, cb.stats
    assert cb.stats["inblock_prefill_steps"] > 0
    off, _ = serve(inblock_refill=False)
    assert off.stats["inblock_refills"] == 0
    assert off.stats["inblock_prefill_steps"] == 0
    assert cb.utilization() > off.utilization()
    assert cb.utilization() >= 0.85, (cb.utilization(), cb.stats)
    s = cb.stats
    assert cb.utilization() == pytest.approx(
        (s["emitted_tokens"] - s["batch_admissions"]
         + s["inblock_prefill_steps"]) / s["slot_steps"])
    assert cb.emitted_per_slot_step() == pytest.approx(
        (s["emitted_tokens"] - s["batch_admissions"]) / s["slot_steps"])


def test_inblock_refill_paged_handoff_exact(params):
    """The paged twin: the handoff switches the row's block table to the
    refill's reserved pages inside the block (the decode kernel reads the
    switched table on the device); oracle-exact, and every page
    recycles."""
    jp, tp = params
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, 256, (L,)).astype(np.int32)
               for L in (5, 17, 40, 9, 23, 12)]
    budgets = [3, 25, 7, 18, 4, 30]
    cb = _port(tp, slots=2, max_len=1024, prompt_buckets=(32, 64),
               steps_per_sync=16, paged=True, decode_kernel=True)
    dense0 = tattn.decode_attention.launches
    rids = _drive(cb, prompts, budgets)
    _assert_exact(jp, cb, rids, prompts, budgets, kernel=True)
    assert cb.stats["inblock_refills"] >= 2, cb.stats
    assert tattn.decode_attention.launches == dense0
    assert len(cb.free_pages) == cb.pool_pages - 1
    assert all(not p for p in cb.slot_pages)
    assert all(not p for p in cb.refill_pages)
    assert (cb.table == 0).all() and (cb.r_table == 0).all()


def test_preempted_request_not_starved_by_refill_handoffs(params):
    """A swapped-out victim gets the next free slot under a sustained
    stream of young short requests: while the resume queue is non-empty
    retiring slots are not handed over in-block, so the victim resumes
    at the next step boundary."""
    jp, tp = params
    rng = np.random.default_rng(25)
    p_long = rng.integers(0, 256, (30,)).astype(np.int32)
    cb = _port(tp, slots=2, max_len=1024, prompt_buckets=(32,), paged=True,
               pool_pages=3, decode_kernel=True, steps_per_sync=32)
    r_long = cb.submit(p_long, max_new=600)   # crosses a page: evicted
    cb.submit(rng.integers(0, 256, (20,)).astype(np.int32), max_new=600)
    steps_to_long = None
    for i in range(200):
        if not cb.pending():
            break
        if i < 40:  # one young short request per step
            cb.submit(rng.integers(0, 256, (8,)).astype(np.int32),
                      max_new=4)
        cb.step()
        if steps_to_long is None and cb.requests[r_long].done:
            steps_to_long = i
    assert not cb.pending()
    assert cb.stats["evictions"] >= 1, cb.stats
    np.testing.assert_array_equal(cb.result(r_long),
                                  _oracle(jp, p_long, 600, kernel=True))
    assert steps_to_long is not None and steps_to_long < 150, steps_to_long


def test_inblock_admit_limit(params):
    """In-block admission takes prompts up to max(steps_per_sync,
    prefill_chunk) tokens (capped at the in-block buffer, the largest
    bucket); the retire -> refill handoff takes the whole buffer."""
    _, tp = params
    assert _port(tp, steps_per_sync=8).inblock_admit_limit == 8
    assert _port(tp, steps_per_sync=8, prefill_chunk=16,
                 prompt_buckets=(32, 64)).inblock_admit_limit == 16
    cb = _port(tp, steps_per_sync=1024, prompt_buckets=(32, 64))
    assert cb.inblock_admit_limit == cb.refill_width == 64


# -- chunked prefill --------------------------------------------------------

def test_chunked_prefill_matches_oracle_and_jax_batcher(params):
    """Chunked prefill (16 tokens per step(), each chunk attending
    causally to the earlier ones through the scratch cache): every
    request stays oracle-exact, and the scheduling counts equal the JAX
    batcher's on the same knobs."""
    jp, tp = params
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, (L,)).astype(np.int32)
               for L in (5, 17, 40, 9, 23)]
    kw = dict(slots=2, max_len=512, temperature=0.0,
              prompt_buckets=(32, 64), prefill_chunk=16)
    jcb = jserve.ContinuousBatcher(jp, JCFG, **kw)
    tcb = tserve.ContinuousBatcher(tp, TCFG, device="cpu", **kw)
    rids = [_drive(cb, prompts, [10] * 5) for cb in (jcb, tcb)][1]
    _assert_exact(jp, tcb, rids, prompts, [10] * 5)
    assert {k: tcb.stats[k] for k in PARITY_KEYS} == \
        {k: jcb.stats[k] for k in PARITY_KEYS}
    assert tcb.stats["prefill_dispatches"] > tcb.stats["batch_admissions"]


def test_chunked_prefill_keeps_slots_emitting(params):
    """While a long prompt admits chunk by chunk, a running slot keeps
    emitting every step: no multi-step stall."""
    jp, tp = params
    rng = np.random.default_rng(5)
    pa = rng.integers(0, 256, (4,)).astype(np.int32)
    pb = rng.integers(0, 256, (60,)).astype(np.int32)   # 4 chunks of 16
    cb = _port(tp, slots=2, max_len=512, prompt_buckets=(16, 64),
               prefill_chunk=16, steps_per_sync=2)
    ra = cb.submit(pa, max_new=40)
    cb.step()                      # admit + start decoding ra
    rb = cb.submit(pb, max_new=4)  # long prompt starts chunked admission
    steps_until_rb, ra_tokens_during = 0, 0
    while not cb.requests[rb].emitted:
        got = cb.step()
        steps_until_rb += 1
        ra_tokens_during += sum(1 for rid, _ in got if rid == ra)
    assert steps_until_rb >= 4, steps_until_rb
    assert ra_tokens_during >= 2 * (steps_until_rb - 1), (
        steps_until_rb, ra_tokens_during)
    while cb.pending():
        cb.step()
    np.testing.assert_array_equal(cb.result(ra), _oracle(jp, pa, 40))
    np.testing.assert_array_equal(cb.result(rb), _oracle(jp, pb, 4))


def test_scheduler_validation(params):
    """The knobs the JAX batcher checks: prefill_chunk must divide every
    bucket and be positive, speculate >= 0, spec_ngram >= 1 when
    speculating; only tensor parallelism and the fleet handoff stay
    refused, naming slice 5."""
    _, tp = params
    with pytest.raises(ValueError, match="divide every"):
        _port(tp, prompt_buckets=(32, 64), prefill_chunk=24)
    with pytest.raises(ValueError, match="prefill_chunk"):
        _port(tp, prefill_chunk=0)
    with pytest.raises(ValueError, match="speculate"):
        _port(tp, speculate=-1)
    with pytest.raises(ValueError, match="spec_ngram"):
        _port(tp, speculate=2, spec_ngram=0)
    for ngram in (1, 3, 5):
        assert _port(tp, speculate=2, spec_ngram=ngram).spec_ngram == ngram
    cb = _port(tp, speculate=4, max_len=512)
    assert cb.kv_len == 1024 and cb.cache["layer0"]["k"].shape[2] == 1024
    for kw in (dict(mesh=object()), dict(tp_axis="tp")):
        with pytest.raises(NotImplementedError, match="slice 5"):
            _port(tp, **kw)


# -- accounting and the early exit at the defaults ---------------------------

def test_stats_account_for_every_slot_step(params):
    """slot_steps == decode-block emissions + in-block prefill steps +
    wasted slot-steps, at the defaults (the third request enters in-block)
    and with refill off (every admission batch-prefills)."""
    _, tp = params
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, (L,)).astype(np.int32)
               for L in (5, 9, 14)]
    cb = _port(tp, slots=2, max_len=512, prompt_buckets=(32,),
               steps_per_sync=4)
    results = cb.run(prompts, max_new=6)
    s = cb.stats
    assert s["slot_steps"] == (s["emitted_tokens"] - s["batch_admissions"]
                               + s["inblock_prefill_steps"]
                               + s["wasted_slot_steps"]), s
    assert s["decode_dispatches"] > 0 and s["batch_admissions"] == 2
    assert s["inblock_prefill_steps"] > 0
    assert all(len(results[r]) == len(prompts[r]) + 6 for r in results)
    cb2 = _port(tp, slots=2, max_len=512, prompt_buckets=(32,),
                steps_per_sync=4, inblock_refill=False)
    results2 = cb2.run(prompts, max_new=6)
    s2 = cb2.stats
    assert s2["prefill_dispatches"] == 3 and s2["batch_admissions"] == 3
    assert s2["inblock_prefill_steps"] == 0 and s2["inblock_refills"] == 0
    assert s2["slot_steps"] == (s2["emitted_tokens"] - 3
                                + s2["wasted_slot_steps"]), s2
    assert all(len(results2[r]) == len(prompts[r]) + 6 for r in results2)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
def test_early_exit_cuts_short_tail_waste(params, overlap):
    """The block ends once every budget is spent: a 5-token request costs
    about its own tokens in slot-steps, not a 32-step block; with overlap
    the device runs at most one more (all-done) step."""
    jp, tp = params
    rng = np.random.default_rng(12)
    p = rng.integers(0, 256, (9,)).astype(np.int32)
    cb = _port(tp, slots=2, max_len=512, prompt_buckets=(32,),
               steps_per_sync=32, overlap=overlap)
    r = cb.submit(p, max_new=5)
    while cb.pending():
        cb.step()
    np.testing.assert_array_equal(cb.result(r), _oracle(jp, p, 5))
    s = cb.stats
    assert s["slot_steps"] <= 8, s
    assert s["slot_steps"] == 2 * (s["decode_steps"] - (1 if overlap else 0))


def test_early_exit_on_eos_cuts_block_short(params):
    """A request that samples its eos ends the block at the eos, not at
    the steps_per_sync boundary."""
    jp, tp = params
    rng = np.random.default_rng(14)
    p = rng.integers(0, 256, (8,)).astype(np.int32)
    oracle = _oracle(jp, p, 32)
    eos = int(oracle[len(p) + 2])
    first_hit = next(i for i in range(32) if int(oracle[len(p) + i]) == eos)
    cb = _port(tp, slots=2, max_len=512, prompt_buckets=(32,),
               steps_per_sync=32)
    r = cb.submit(p, max_new=32, eos_id=eos)
    while cb.pending():
        cb.step()
    out = cb.result(r)
    assert out[-1] == eos and len(out) == len(p) + first_hit + 1
    assert cb.stats["slot_steps"] <= 2 * (first_hit + 2), cb.stats


def test_timing_stats_phases(params):
    """Every phase of the overlapped loop is timed, and each block lands
    one fetch segment."""
    _, tp = params
    cb = _port(tp, slots=2, max_len=512, prompt_buckets=(32, 64),
               steps_per_sync=8)
    cb.run(_ragged_workload(36, 3), max_new=12)
    ts = cb.timing_stats()
    for phase in ("host_plan", "dispatch", "fetch", "host_parse",
                  "prefill"):
        assert ts[phase]["segments"] > 0 and ts[phase]["total_s"] >= 0
        assert {"p50_s", "p95_s", "max_s"} <= set(ts[phase])
    assert ts["fetch"]["segments"] == cb.stats["decode_dispatches"]
    assert cb.stats["chained_dispatches"] > 0


def test_int8_cache_default_scheduler_parity_with_jax_batcher(params):
    """kv_dtype=int8 at the defaults: quantized writes from teacher-forced
    prompt steps, refill handoffs and chained blocks; the same tokens and
    counts as the JAX batcher."""
    jp, tp = params
    prompts, budgets = _refill_workload()
    kw = dict(slots=2, max_len=512, temperature=0.0,
              prompt_buckets=(32, 64), steps_per_sync=8, kv_dtype="int8")
    jcb = jserve.ContinuousBatcher(jp, JCFG, **kw)
    tcb = tserve.ContinuousBatcher(tp, TCFG, device="cpu", **kw)
    rids = [_drive(cb, prompts, budgets) for cb in (jcb, tcb)][1]
    for rid in rids:
        np.testing.assert_array_equal(tcb.result(rid), jcb.result(rid))
    assert {k: tcb.stats[k] for k in PARITY_KEYS} == \
        {k: jcb.stats[k] for k in PARITY_KEYS}
    assert tcb.stats["inblock_refills"] >= 1


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the done flags and the packed results "
                    "come back through pinned memory behind events only "
                    "there")
    return torch.device("cuda")


# the decode kernels take head_dim 64 or 128
CARD_SHAPE = dict(SHAPE, head_dim=64)
JCFG_CARD = jtfm.TransformerConfig(**CARD_SHAPE)
TCFG_CARD = ttfm.TransformerConfig(**CARD_SHAPE)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_overlap_pinned_path_on_card(cuda, paged):
    """The card's device->host path (each step's done flag and each
    block's packed results copied non-blocking into pinned memory behind
    an event, the flag buffer reused across chained blocks): overlap on
    and off give the JAX greedy streams through in-block refill handoffs
    and an eos firing mid-chain, a seeded temperature-0.8 load is bitwise
    equal on and off, and the overlapped side chained through pinned
    flags."""
    jp = jtfm.init(jax.random.key(0), JCFG_CARD)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp), device=cuda)

    def oracle(p, n):  # the JAX XLA decode path (no kernel on its side)
        return _oracle(jp, p, n, cfg=JCFG_CARD)

    prompts, budgets = _refill_workload()
    rng = np.random.default_rng(32)
    pe = rng.integers(0, 256, (8,)).astype(np.int32)
    oracle_e = oracle(pe, 40)
    eos = int(oracle_e[len(pe) + 9])
    hit = next(i for i in range(40) if int(oracle_e[len(pe) + i]) == eos)
    geom = dict(max_len=1024 if paged else 512, prompt_buckets=(32, 64),
                steps_per_sync=4, paged=paged, device=cuda)

    def greedy(overlap):
        cb = tserve.ContinuousBatcher(tp, TCFG_CARD, slots=2,
                                      temperature=0.0,
                                      overlap=overlap, **geom)
        rids = [cb.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
        re = cb.submit(pe, max_new=40, eos_id=eos)
        while cb.pending():
            cb.step()
        return cb, [cb.result(r) for r in rids], cb.result(re)

    (cb_on, on, on_e), (cb_off, off, off_e) = greedy(True), greedy(False)
    assert cb_on._pinned and cb_on._flags is not None
    assert cb_on.stats["chained_dispatches"] > 0, cb_on.stats
    assert cb_on.stats["inblock_refills"] > 0, cb_on.stats
    assert cb_off.stats["chained_dispatches"] == 0
    for got_on, got_off, p, b in zip(on, off, prompts, budgets):
        np.testing.assert_array_equal(got_on, oracle(p, b))
        np.testing.assert_array_equal(got_off, got_on)
    np.testing.assert_array_equal(on_e, oracle_e[:len(pe) + hit + 1])
    np.testing.assert_array_equal(off_e, on_e)

    sp = _ragged_workload(34, 3, lens=(6, 13, 9))
    sb = [30, 22, 26]

    def sampled(overlap):
        cb = tserve.ContinuousBatcher(tp, TCFG_CARD, slots=3,
                                      temperature=0.8,
                                      top_k=40, seed=7, overlap=overlap,
                                      **geom)
        rids = [cb.submit(p, max_new=b) for p, b in zip(sp, sb)]
        while cb.pending():
            cb.step()
        return cb, [cb.result(r) for r in rids]

    (cs_on, s_on), (_, s_off) = sampled(True), sampled(False)
    assert cs_on.stats["chained_dispatches"] > 0, cs_on.stats
    for a, b, p, n in zip(s_on, s_off, sp, sb):
        np.testing.assert_array_equal(a, b)
        assert len(a) == len(p) + n
