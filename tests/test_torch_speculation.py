"""The port's speculative decoding against the JAX package, on the CPU in
float32: the static paths (distributed_pytorch_tpu_torch/generate.py
``generate_speculative``, ``generate_lookup`` and their primitives) and
the batcher's in-block speculation (serve.py ``speculate``).

Oracles: the JAX functions on the same weights (carried by convert.py),
prompts and knobs as tests/test_lm_data_gen.py and tests/test_serve.py
use them: greedy tokens, and the speculation counts, must be equal.
``lookup_proposals`` is held bitwise.  Sampled speculation is held to the
analytic warped-target marginal of generated position 1
(test_lm_data_gen's ``_marginal_pos1``) in total variation, with plain
sampled decoding at the same sample count as the calibration: TV < 0.13,
the JAX tests' tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_lm_data_gen import _marginal_pos1

from distributed_pytorch_tpu import generate as jgen
from distributed_pytorch_tpu import serve as jserve
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import generate as tgen
from distributed_pytorch_tpu_torch import serve as tserve
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from distributed_pytorch_tpu_torch.ops import attention as tattn

# tests/test_lm_data_gen.py's model and draft, tests/test_serve.py's
# speculation model
GEN = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2, head_dim=64)
DRAFT = dict(vocab_size=256, d_model=64, n_layers=1, n_heads=2, head_dim=32,
             d_ff=128)
SPEC = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            d_ff=128)
TV_TOL = 0.13


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU shapes: parallel test workers
    each running torch's default thread pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(shape, seed):
    """(JAX cfg, port cfg, JAX params, port params) for ``shape``."""
    jcfg = jtfm.TransformerConfig(**shape)
    jp = jtfm.init(jax.random.key(seed), jcfg)
    return (jcfg, ttfm.TransformerConfig(**shape), jp,
            convert.from_jax_params(jax.tree.map(np.asarray, jp),
                                    device="cpu"))


@pytest.fixture(scope="module")
def gen_model():
    return _pair(GEN, 0)


@pytest.fixture(scope="module")
def draft_model():
    return _pair(DRAFT, 1)


@pytest.fixture(scope="module")
def spec_model():
    return _pair(SPEC, 0)


def _jax_greedy(jp, jcfg, prompt, max_new, eos_id=None):
    return np.asarray(jgen.generate(
        jp, jnp.asarray(prompt), jax.random.key(2), cfg=jcfg,
        max_new=max_new, temperature=0.0, eos_id=eos_id))


# -- primitives -------------------------------------------------------------

@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_lookup_proposals_bitwise_equal_to_jax(ngram):
    """Random streams over a small vocabulary (so n-grams recur), every
    trailing index from 0 (a prefix shorter than the n-gram: repeat-last
    fallback) to the end."""
    rng = np.random.default_rng(ngram)
    stream = rng.integers(0, 5, (6, 40)).astype(np.int32)
    for last in range(40):
        last_i = np.full(6, last, np.int32)
        last_i[::2] = rng.integers(0, last + 1, 3)   # ragged rows
        for n_spec in (1, 4):
            want = np.asarray(jgen.lookup_proposals(
                jnp.asarray(stream), jnp.asarray(last_i), n_spec, ngram))
            got = tgen.lookup_proposals(torch.from_numpy(stream),
                                        torch.from_numpy(last_i), n_spec,
                                        ngram)
            np.testing.assert_array_equal(got.numpy(), want)


def test_rejection_sampling_marginal_is_exact():
    """``_spec_reject_tokens``: for p != q the accept-or-resample output at
    the first position is distributed exactly as p (Monte Carlo against
    the analytic row), and the naive always-accept baseline is not."""
    rng = np.random.default_rng(0)
    v, k, n = 8, 3, 40_000
    p_row = rng.dirichlet(np.ones(v) * 0.7, size=k + 1).astype(np.float32)
    q_row = rng.dirichlet(np.ones(v) * 0.7, size=k).astype(np.float32)
    p = torch.from_numpy(p_row).expand(n, k + 1, v)
    q = torch.from_numpy(q_row).expand(n, k, v)
    g = torch.Generator().manual_seed(42)
    drafts = torch.multinomial(q.reshape(-1, v), 1, generator=g).reshape(n, k)
    match, toks = tgen._spec_reject_tokens(g, drafts.to(torch.int32), q, p)
    first = torch.where(match[:, 0], drafts[:, 0], toks[:, 0]).numpy()
    emp = np.bincount(first, minlength=v) / n
    assert 0.5 * np.abs(emp - p_row[0]).sum() < 0.02
    emp_q = np.bincount(drafts[:, 0].numpy(), minlength=v) / n
    assert 0.5 * np.abs(emp_q - p_row[0]).sum() > 0.1


# -- static speculation -----------------------------------------------------

def test_speculative_matches_jax_greedy(gen_model, draft_model):
    """Greedy ``generate_speculative`` equals JAX's (and the target's plain
    greedy stream), tokens and counts, for an unrelated draft and for the
    target as its own draft (every proposal accepted)."""
    jcfg, tcfg, jp, tp = gen_model
    jdcfg, tdcfg, jd, td = draft_model
    rng = np.random.default_rng(0)
    cases = [(jd, td, jdcfg, tdcfg, b, s0, new)
             for b, s0, new in [(1, 7, 24), (3, 12, 33)]]
    cases.append((jp, tp, jcfg, tcfg, 2, 10, 30))
    for jdp, tdp, jdc, tdc, b, s0, new in cases:
        prompt = rng.integers(0, 256, (b, s0)).astype(np.int32)
        want, jst = jgen.generate_speculative(
            jp, jdp, jnp.asarray(prompt), cfg=jcfg, draft_cfg=jdc,
            max_new=new, n_spec=4)
        got, st = tgen.generate_speculative(
            tp, tdp, prompt, cfg=tcfg, draft_cfg=tdc, max_new=new, n_spec=4,
            device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(),
                                      _jax_greedy(jp, jcfg, prompt, new))
        assert st == {k: int(v) for k, v in jst.items()}
    assert st["accepted"] >= 0.9 * st["drafted"], st


def test_speculative_eos_stops(gen_model):
    """A sequence that emits its eos stops there, with generate()'s
    fixed-shape eos-repeat tail."""
    jcfg, tcfg, jp, tp = gen_model
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, (1, 8)).astype(np.int32)
    eos = int(_jax_greedy(jp, jcfg, prompt, 12)[0, 8 + 2])
    want = _jax_greedy(jp, jcfg, prompt, 12, eos_id=eos)
    got, _ = tgen.generate_speculative(tp, tp, prompt, cfg=tcfg,
                                       draft_cfg=tcfg, max_new=12, n_spec=3,
                                       eos_id=eos, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_lookup_matches_jax_greedy(gen_model):
    """Greedy ``generate_lookup`` equals JAX's, tokens and counts, on
    random prompts (lookups mostly rejected) and a repetitive one
    (lookups accepted)."""
    jcfg, tcfg, jp, tp = gen_model
    rng = np.random.default_rng(7)
    cases = [(rng.integers(0, 256, (b, s0)).astype(np.int32), new, 6)
             for b, s0, new in [(1, 9, 25), (3, 16, 34)]]
    cases.append((np.tile(np.asarray([5, 9, 23, 7], np.int32), 8)[None],
                  20, 6))
    for prompt, new, n_spec in cases:
        want, jst = jgen.generate_lookup(jp, jnp.asarray(prompt), cfg=jcfg,
                                         max_new=new, n_spec=n_spec)
        got, st = tgen.generate_lookup(tp, prompt, cfg=tcfg, max_new=new,
                                       n_spec=n_spec, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(),
                                      _jax_greedy(jp, jcfg, prompt, new))
        assert st == {k: int(v) for k, v in jst.items()}


def test_lookup_eos_matches_generate(gen_model):
    jcfg, tcfg, jp, tp = gen_model
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 256, (2, 10)).astype(np.int32)
    eos = int(_jax_greedy(jp, jcfg, prompt, 16)[0, 10 + 3])
    want = _jax_greedy(jp, jcfg, prompt, 16, eos_id=eos)
    got, _ = tgen.generate_lookup(tp, prompt, cfg=tcfg, max_new=16,
                                  n_spec=5, eos_id=eos, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_speculation_requires_generator(spec_model):
    _, tcfg, _, tp = spec_model
    prompt = np.asarray([[1, 2, 3]], np.int32)
    with pytest.raises(ValueError, match="needs a generator"):
        tgen.generate_lookup(tp, prompt, cfg=tcfg, max_new=4,
                             temperature=0.5, device="cpu")
    with pytest.raises(ValueError, match="needs a generator"):
        tgen.generate_speculative(tp, tp, prompt, cfg=tcfg, draft_cfg=tcfg,
                                  max_new=4, temperature=0.5, device="cpu")


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(0.9, None, None), (1.0, 5, None),
                          (0.8, None, 0.9)])
def test_sampled_static_speculation_marginal(temperature, top_k, top_p):
    """Sampled ``generate_speculative`` (draft rejection sampling) and
    ``generate_lookup`` (point-mass rejection): generated position 1
    follows the warped target marginal within TV 0.13 over 768 samples,
    as the port's plain sampled ``generate`` does (the calibration)."""
    shape = dict(vocab_size=32, d_model=32, n_layers=1, n_heads=2,
                 head_dim=16, d_ff=64)
    jcfg, tcfg, jp, tp = _pair(shape, 0)
    _, tdcfg, _, td = _pair(dict(vocab_size=32, d_model=16, n_layers=1,
                                 n_heads=1, head_dim=16, d_ff=32), 1)
    prompt1 = np.asarray([[3, 17, 5, 9]], np.int32)
    want = _marginal_pos1(jp, jcfg, jnp.asarray(prompt1), temperature,
                          top_k, top_p)
    b, reps, s0 = 256, 3, prompt1.shape[1]
    prompt = np.ascontiguousarray(np.broadcast_to(prompt1, (b, s0)))
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
              device="cpu")

    def tv_of(sample_fn):
        toks = np.concatenate([sample_fn(100 + r).numpy()[:, s0 + 1]
                               for r in range(reps)])
        emp = np.bincount(toks, minlength=32) / len(toks)
        return 0.5 * np.abs(emp - want).sum()

    tv_plain = tv_of(lambda seed: tgen.generate(
        tp, prompt, seed, cfg=tcfg, max_new=3, **kw))
    tv_spec = tv_of(lambda seed: tgen.generate_speculative(
        tp, td, prompt, seed, cfg=tcfg, draft_cfg=tdcfg, max_new=3,
        n_spec=3, **kw)[0])
    tv_lookup = tv_of(lambda seed: tgen.generate_lookup(
        tp, prompt, seed, cfg=tcfg, max_new=3, n_spec=3, ngram=2, **kw)[0])
    assert tv_plain < TV_TOL, tv_plain
    assert tv_spec < TV_TOL, (tv_spec, tv_plain)
    assert tv_lookup < TV_TOL, (tv_lookup, tv_plain)


# -- in-batcher speculation -------------------------------------------------

def _spec_workload():
    rng = np.random.default_rng(0)
    prompts = [np.tile(np.asarray([5, 9, 23, 7], np.int32), 6),
               rng.integers(0, 64, (9,)).astype(np.int32),
               np.tile(np.asarray([3, 11], np.int32), 8),
               rng.integers(0, 64, (15,)).astype(np.int32),
               np.tile(np.asarray([40, 2, 19], np.int32), 5)]
    return prompts, [18, 7, 25, 12, 21]


_ORACLE: dict = {}


def _spec_oracle(jp, jcfg, prompt, max_new, eos_id=None):
    key = (np.asarray(prompt, np.int32).tobytes(), max_new, eos_id)
    if key not in _ORACLE:
        _ORACLE[key] = np.asarray(jgen.generate(
            jp, jnp.asarray(prompt)[None], jax.random.key(0), cfg=jcfg,
            max_new=max_new, temperature=0.0, eos_id=eos_id))[0]
    return _ORACLE[key]


def _spec_batcher(tp, tcfg, **kw):
    kw.setdefault("max_len", 512)
    kw.setdefault("prompt_buckets", (32,))
    return tserve.ContinuousBatcher(tp, tcfg, slots=2, temperature=0.0,
                                    steps_per_sync=4, speculate=4,
                                    device="cpu", **kw)


def _drive(cb, prompts, budgets, **submit_kw):
    rids = [cb.submit(p, max_new=b, **submit_kw)
            for p, b in zip(prompts, budgets)]
    while cb.pending():
        cb.step()
    return rids


SPEC_KEYS = ("spec_rounds", "spec_proposed", "spec_accepted",
             "decode_dispatches", "slot_steps", "emitted_tokens",
             "batch_admissions", "prefill_dispatches",
             "inblock_prefill_steps", "inblock_refills",
             "wasted_slot_steps", "evictions", "swap_ins",
             "compact_dispatches")


@pytest.mark.parametrize("kw", [dict(), dict(paged=True),
                                dict(paged=True, pool_pages=3)],
                         ids=["dense", "paged", "paged_pool3"])
def test_spec_serving_oracle_exact_and_equal_to_jax(spec_model, kw):
    """Greedy in-batcher speculation (per-slot prompt-lookup proposals,
    one ragged verify window a round) is exactly the greedy stream for
    every request, across slot recycling, refill handoffs, dense and
    paged pools; the lookup-friendly load accepts proposals; and the
    speculation and scheduling counts equal the JAX batcher's.  No
    decode-kernel launch: the verify window attends through reference
    attention, as in JAX."""
    jcfg, tcfg, jp, tp = spec_model
    prompts, budgets = _spec_workload()
    cb = _spec_batcher(tp, tcfg, **kw)
    launches0 = (tattn.decode_attention.launches,
                 tattn.decode_attention_paged.launches)
    rids = _drive(cb, prompts, budgets)
    for r, p, b in zip(rids, prompts, budgets):
        np.testing.assert_array_equal(cb.result(r),
                                      _spec_oracle(jp, jcfg, p, b))
    s = cb.stats
    assert s["spec_rounds"] > 0 and s["spec_proposed"] > 0
    assert 0 < s["spec_accepted"] <= s["spec_proposed"]
    assert s["spec_accepted"] / s["spec_proposed"] > 0.1, s
    assert (tattn.decode_attention.launches,
            tattn.decode_attention_paged.launches) == launches0
    jcb = jserve.ContinuousBatcher(
        jp, jcfg, slots=2, temperature=0.0, steps_per_sync=4, speculate=4,
        max_len=512, prompt_buckets=(32,), **kw)
    _drive(jcb, prompts, budgets)
    assert {k: s[k] for k in SPEC_KEYS} == {k: jcb.stats[k]
                                            for k in SPEC_KEYS}


def test_spec_serving_eos_exact(spec_model):
    jcfg, tcfg, jp, tp = spec_model
    p = _spec_workload()[0][0]
    eos = int(_spec_oracle(jp, jcfg, p, 18)[len(p) + 3])
    weos = _spec_oracle(jp, jcfg, p, 18, eos_id=eos)
    cut = int(np.where(weos[len(p):] == eos)[0][0]) + 1
    cb = _spec_batcher(tp, tcfg)
    rid = _drive(cb, [p], [18], eos_id=eos)[0]
    np.testing.assert_array_equal(cb.result(rid), weos[:len(p) + cut])


def test_spec_serving_preemption_exact(spec_model):
    """Speculation x host-swap preemption: two identical requests cross the
    512-token page boundary in the same block on a 3-usable-page pool, so
    one is evicted mid-generation; both streams stay exact."""
    jcfg, tcfg, jp, tp = spec_model
    rng = np.random.default_rng(3)
    p = np.tile(rng.integers(0, 64, (4,)).astype(np.int32), 8)
    cb = _spec_batcher(tp, tcfg, max_len=1024, paged=True, pool_pages=4)
    rids = _drive(cb, [p, p], [610, 610])
    want = _spec_oracle(jp, jcfg, p, 610)
    for r in rids:
        np.testing.assert_array_equal(cb.result(r), want)
    assert cb.stats["evictions"] > 0 and cb.stats["swap_ins"] > 0, cb.stats


def test_spec_serving_stats_identity_and_adjusted_utilization(spec_model):
    """Speculation accounting: slot_steps counts verify positions (rounds
    x slots x window), useful work is bounded by them, utilization() is
    that ratio, and emitted_per_slot_step() is the same denominator over
    emissions alone; greedy runs are deterministic."""
    _, tcfg, _, tp = spec_model
    prompts, _ = _spec_workload()

    def run():
        cb = _spec_batcher(tp, tcfg)
        cb.run(prompts, max_new=8)
        return cb

    a, b = run(), run()
    assert a.stats == b.stats
    s = a.stats
    useful = (s["emitted_tokens"] - s["batch_admissions"]
              + s["inblock_prefill_steps"])
    assert 0 < useful <= s["slot_steps"] + s["spec_rounds"] * a.slots, s
    assert s["slot_steps"] == s["spec_rounds"] * a.slots * (a.n_spec + 1)
    assert abs(a.utilization() - useful / s["slot_steps"]) < 1e-9
    assert a.emitted_per_slot_step() == (
        (s["emitted_tokens"] - s["batch_admissions"]) / s["slot_steps"])
    assert abs(a.utilization() - a.emitted_per_slot_step()
               - s["inblock_prefill_steps"] / s["slot_steps"]) < 1e-12
    assert 0.0 < a.emitted_per_slot_step() <= a.utilization() <= 1.0


def test_prefix_cache_composes_with_speculation(spec_model):
    """prefix_cache x speculate: shared-prefix admissions then speculative
    decode; exact streams, hits recorded, and the verify window's clamped
    writes never corrupt the shared pages (a second wave decodes the
    same)."""
    jcfg, tcfg, jp, tp = spec_model
    rng = np.random.default_rng(2)
    sysp = np.tile(rng.integers(0, 64, (8,)).astype(np.int32), 65)[:516]
    prompts = [np.concatenate([sysp,
                               rng.integers(0, 64, (5,)).astype(np.int32)])
               for _ in range(3)]
    cb = _spec_batcher(tp, tcfg, max_len=1024, prompt_buckets=(32, 1024),
                       paged=True, prefix_cache=True)
    for _ in range(2):
        rids = _drive(cb, prompts, [12] * 3)
        for r, p in zip(rids, prompts):
            np.testing.assert_array_equal(cb.result(r),
                                          _spec_oracle(jp, jcfg, p, 12))
    assert cb.stats["prefix_hits"] >= 5, cb.stats
    assert cb.stats["spec_rounds"] > 0


def test_spec_serving_sampled_distribution(spec_model):
    """Sampled in-batcher speculation keeps the warped target
    distribution: the block's own point-mass rejection sampler, pinned
    against the analytic marginal of generated position 1, with plain
    (speculate=0) sampled serving as the calibration at the same count
    (768 samples: 4 seeds x 192 requests through 8 slots)."""
    jcfg, tcfg, jp, tp = spec_model
    prompt = np.asarray([3, 17, 5, 9], np.int32)
    want = _marginal_pos1(jp, jcfg, jnp.asarray(prompt)[None], 1.0, None,
                          None)

    def harvest(speculate, reps=4, slots=8, requests=192):
        toks = []
        for rep in range(reps):
            cb = tserve.ContinuousBatcher(
                tp, tcfg, slots=slots, max_len=512, temperature=1.0,
                steps_per_sync=2, prompt_buckets=(32,), speculate=speculate,
                seed=100 + rep, device="cpu")
            rids = _drive(cb, [prompt] * requests, [2] * requests)
            toks += [cb.result(r)[len(prompt) + 1] for r in rids]
        emp = np.bincount(np.asarray(toks), minlength=tcfg.vocab_size)
        return 0.5 * np.abs(emp / len(toks) - want).sum()

    tv_spec, tv_plain = harvest(speculate=3), harvest(speculate=0)
    assert tv_plain < TV_TOL, tv_plain
    assert tv_spec < TV_TOL, (tv_spec, tv_plain)
