"""The port's continuous batcher (distributed_pytorch_tpu_torch/serve.py)
against the JAX package's greedy oracle, on the CPU in float32.

Oracle: the JAX static ``generate()`` at temperature 0 with the XLA decode
path, exactly as tests/test_serve.py calls it (same model, weights and
prompts, so its compiled programs are reused).  Greedy tokens must match
exactly, whatever slot served a request.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import generate as jgen
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from distributed_pytorch_tpu_torch.serve import ContinuousBatcher

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


def _greedy_oracle(jp, prompt, max_new):
    return np.asarray(jgen.generate(
        jp, jnp.asarray(prompt)[None], jax.random.key(1), cfg=JCFG,
        max_new=max_new, temperature=0.0, decode_kernel=False))[0]


def _batcher(tp, **kw):
    kw.setdefault("max_len", 512)
    return ContinuousBatcher(tp, TCFG, device="cpu", **kw)


@pytest.mark.parametrize("schedule", ["fifo", "longest_first"])
def test_matches_jax_oracle_with_slot_recycling(params, schedule):
    """5 ragged requests through 2 slots on the serial path (in-block
    refill and overlap off, so every admission is a batched prefill):
    every sequence decodes exactly as the JAX static generation does;
    recycled slots' stale K/V never leaks."""
    jp, tp = params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (L,)).astype(np.int32)
               for L in (5, 17, 40, 9, 23)]
    cb = _batcher(tp, slots=2, temperature=0.0, prompt_buckets=(32, 64),
                  schedule=schedule, inblock_refill=False, overlap=False)
    results = cb.run(prompts, max_new=10)
    for rid, prompt in enumerate(prompts):
        np.testing.assert_array_equal(results[rid],
                                      _greedy_oracle(jp, prompt, 10))
    st = cb.stats
    assert st["emitted_tokens"] == 50 and st["prefill_dispatches"] == 5
    assert st["batch_admissions"] == 5
    assert st["slot_steps"] == 2 * st["decode_steps"]
    assert st["wasted_slot_steps"] == st["slot_steps"] - 45
    assert 0.0 < cb.utilization() <= 1.0
    assert cb.latency_stats()["completed"] == 5
    assert {"host_plan", "prefill", "dispatch", "fetch", "host_parse"} <= \
        set(cb.timing_stats())


def test_eos_retires_slot_early(params):
    """A sequence that samples eos_id retires at once and its slot serves
    the next request; the other's tokens are unaffected."""
    jp, tp = params
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, 256, (8,)).astype(np.int32)
    first = int(_greedy_oracle(jp, p1, 1)[-1])
    p2 = rng.integers(0, 256, (12,)).astype(np.int32)
    cb = _batcher(tp, slots=1, temperature=0.0, eos_id=first,
                  prompt_buckets=(32,))
    r1 = cb.submit(p1, max_new=10)
    r2 = cb.submit(p2, max_new=4)
    while cb.pending():
        cb.step()
    out1, out2 = cb.result(r1), cb.result(r2)
    assert len(out1) == len(p1) + 1 and out1[-1] == first
    assert len(out2) == len(p2) + 4
    want2 = _greedy_oracle(jp, p2, 4)
    for t in range(len(p2), len(p2) + 4):
        assert out2[t] == want2[t]
        if out2[t] == first:
            break


def test_per_request_sampling_params(params):
    """A greedy request stays oracle-exact in a hot pool; top_k=1 and a
    tiny top_p degenerate to greedy; eos_id=None disables the default."""
    jp, tp = params
    rng = np.random.default_rng(6)
    pa, pb, pc, pd = (rng.integers(0, 256, (n,)).astype(np.int32)
                      for n in (7, 11, 9, 13))
    cb = _batcher(tp, slots=4, temperature=1.5, prompt_buckets=(32,),
                  eos_id=int(_greedy_oracle(jp, pa, 1)[-1]))
    ra = cb.submit(pa, max_new=8, temperature=0.0, eos_id=None)
    rb = cb.submit(pb, max_new=8)
    rc = cb.submit(pc, max_new=8, temperature=1.0, top_k=1, eos_id=None)
    rd = cb.submit(pd, max_new=8, temperature=1.0, top_p=1e-6, eos_id=None)
    while cb.pending():
        cb.step()
    for rid, p in ((ra, pa), (rc, pc), (rd, pd)):
        np.testing.assert_array_equal(cb.result(rid),
                                      _greedy_oracle(jp, p, 8))
    assert len(pb) < len(cb.result(rb)) <= len(pb) + 8


def test_interleaved_submission_and_block_sizes(params):
    """A request submitted mid-stream, and a one-step block size, stay
    oracle-exact."""
    jp, tp = params
    rng = np.random.default_rng(2)
    pa = rng.integers(0, 256, (6,)).astype(np.int32)
    pb = rng.integers(0, 256, (14,)).astype(np.int32)
    cb = _batcher(tp, slots=2, temperature=0.0, prompt_buckets=(32,),
                  steps_per_sync=1)
    ra = cb.submit(pa, max_new=8)
    cb.step()
    cb.step()
    assert cb.queue_depth() == 0
    rb = cb.submit(pb, max_new=6)
    assert cb.queue_depth() == 1
    while cb.pending():
        cb.step()
    np.testing.assert_array_equal(cb.result(ra), _greedy_oracle(jp, pa, 8))
    np.testing.assert_array_equal(cb.result(rb), _greedy_oracle(jp, pb, 6))


def test_int8_cache_batcher_matches_int8_generate(params):
    """kv_dtype=int8: the batcher equals the port's own static generate
    with the same quantized cache (greedy)."""
    from distributed_pytorch_tpu_torch import generate as tgen
    _, tp = params
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, (L,)).astype(np.int32) for L in (4, 21)]
    cb = _batcher(tp, slots=2, temperature=0.0, prompt_buckets=(32,),
                  kv_dtype="int8")
    res = cb.run(prompts, max_new=6)
    for rid, p in enumerate(prompts):
        want = tgen.generate(tp, p[None], cfg=TCFG, max_new=6,
                             temperature=0.0, kv_dtype="int8",
                             device="cpu")[0].numpy()
        np.testing.assert_array_equal(res[rid], want)


def test_submission_validation(params):
    _, tp = params
    cb = _batcher(tp, slots=1, prompt_buckets=(32,))
    with pytest.raises(ValueError, match="empty"):
        cb.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="bucket"):
        cb.submit(np.zeros((100,), np.int32))
    with pytest.raises(ValueError, match="max_len"):
        cb.submit(np.zeros((8,), np.int32), max_new=512)
    with pytest.raises(ValueError, match="max_new"):
        cb.submit(np.zeros((8,), np.int32), max_new=0)
    with pytest.raises(ValueError, match="schedule"):
        _batcher(tp, schedule="lifo")
    with pytest.raises(ValueError, match="steps_per_sync"):
        _batcher(tp, steps_per_sync=0)
    with pytest.raises(ValueError, match="bucket"):
        _batcher(tp, max_len=16, prompt_buckets=(1024,))


REFUSED = [dict(mesh=object()), dict(tp_axis="tp")]


@pytest.mark.parametrize("kw", REFUSED, ids=[next(iter(k)) for k in REFUSED])
def test_unported_knobs_are_refused(params, kw):
    _, tp = params
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _batcher(tp, **kw)


@pytest.mark.parametrize("method", ["export_request", "import_request"])
def test_fleet_handoff_is_refused(params, method):
    _, tp = params
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        getattr(_batcher(tp, slots=1), method)(0)
