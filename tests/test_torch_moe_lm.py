"""MoE through the port's model, trainer, decode and batcher
(distributed_pytorch_tpu_torch: models/transformer.py, lm.py,
generate.py, serve.py, convert.py) against the JAX package's, on the CPU in
float32.

The model is tests/test_torch_lm.py's (vocab 256, d_model 128, 2 layers,
2 heads x 64, d_ff 256) with 4 experts: layer 1 is MoE (``moe_every=2``),
capacity factor 2.  Weights and optimizer state cross by convert.py.

- ``apply(return_aux=True)``: logits to 1e-4 (tests/test_torch_
  transformer.py's tolerance), the summed aux to rtol 1e-6, with and
  without full remat (the aux leaves the checkpointed block; remat's
  gradients equal the plain apply's to 1e-6);
- three f32 ``LMTrainer`` steps from the JAX trainer's initial params, for
  top-1, top-2, expert choice and top-1 with ``grad_accum=2`` (each
  microbatch its own routing group, ``aux_w = aux_coef / 2``): losses to
  rtol 1e-5; params to rtol 1e-5 / atol 1e-6 for all but 0.1% of each
  tensor's entries, and every entry within tests/test_torch_lm.py's
  rtol 1e-4 / atol 5e-4 (Adam divides by sqrt(nu), which amplifies
  float32 summation-order noise on near-zero gradient entries: a few in
  32,768 land ~1e-5 apart); and eval;
- greedy tokens of ``generate``, ``generate_speculative``,
  ``generate_lookup`` and the batcher (dense, paged, in-batcher
  speculation, at its defaults) equal to the JAX static ``generate``'s:
  decode runs ``_moe_dense`` (every expert on every token, no capacity)
  in both packages; the expert-choice warning;
- ``convert.py`` round-trips an MoE parameter tree and its optax Adam
  state bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import generate as jgen
from distributed_pytorch_tpu import lm as jlm
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import generate as tgen
from distributed_pytorch_tpu_torch import lm as tlm
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from distributed_pytorch_tpu_torch.serve import ContinuousBatcher

SHAPE = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
             head_dim=64, d_ff=256, n_experts=4)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_FAR_SHARE = 1e-3           # entries allowed outside PARAM_TOL
PARAM_TOL_ALL = dict(rtol=1e-4, atol=5e-4)  # tests/test_torch_lm.py's
TRAIN_CASES = {
    "top1": (dict(), dict()),
    "top2": (dict(moe_top_k=2), dict()),
    "experts": (dict(moe_router="experts"), dict()),
    "top1_grad_accum2": (dict(), dict(grad_accum=2)),
}
SERVE_MODEL = dict(SHAPE, moe_top_k=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(b=4, s=128, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1).astype(np.int32)
    targets[:, -1] = jlm.IGNORE
    return tokens, targets


def _models(**kw):
    return (jtfm.TransformerConfig(**dict(SHAPE, **kw)),
            ttfm.TransformerConfig(**dict(SHAPE, **kw)))


@pytest.mark.parametrize("remat", [None, "full"])
def test_apply_returns_the_summed_aux(remat):
    jcfg, tcfg = _models(router_z_coef=0.1)
    jp = jtfm.init(jax.random.key(0), jcfg)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(4).integers(0, 256, (2, 24))
    want, want_aux = jtfm.apply(jp, jnp.asarray(toks, jnp.int32), cfg=jcfg,
                                attn_impl="reference", return_aux=True,
                                remat=remat)
    grads = []
    for mode in (None, remat):
        leaves = {n: p.clone().requires_grad_(True) for n, p in tp.items()}
        got, aux = ttfm.apply(leaves, torch.from_numpy(toks), cfg=tcfg,
                              attn_impl="reference", return_aux=True,
                              remat=mode)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(float(aux.detach()), float(want_aux),
                                   rtol=1e-6)
        (got.square().mean() + aux).backward()
        grads.append({n: p.grad for n, p in leaves.items()})
    assert grads[0]["layers.1.moe.router"].abs().sum() > 0
    for n in tp:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6,
                                   atol=1e-7)


def _jax_trainer_run(model_kw, cfg_kw, steps=3):
    cfg = jlm.LMTrainConfig(
        model=jtfm.TransformerConfig(**dict(SHAPE, **model_kw)),
        compute_dtype=None, **cfg_kw)
    jtr = jlm.LMTrainer(cfg)
    batches = [_data(), _data(seed=1)]
    init = jax.tree.map(np.array, jtr.params)
    losses = [float(jtr.train_step(*batches[i % 2])) for i in range(steps)]
    return (jtr, batches, init, losses, jax.tree.map(np.array, jtr.params),
            jax.tree.map(np.array, jtr.opt_state))


@pytest.fixture(scope="module")
def top1_run():
    return _jax_trainer_run(*TRAIN_CASES["top1"])


def _port_trainer(model_kw, cfg_kw, init):
    cfg = tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**dict(SHAPE, **model_kw)),
        compute_dtype=None, **cfg_kw)
    ttr = tlm.LMTrainer(cfg, device="cpu")
    ttr.load_state(convert.from_jax_params(init, device="cpu"))
    return ttr


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_moe_trainer_matches_jax(name, top1_run):
    model_kw, cfg_kw = TRAIN_CASES[name]
    jtr, batches, init, want, jparams, _ = (
        top1_run if name == "top1" else _jax_trainer_run(model_kw, cfg_kw))
    ttr = _port_trainer(model_kw, cfg_kw, init)
    got = [float(ttr.train_step(*batches[i % 2])) for i in range(3)]
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    want_p = convert.from_jax_params(jparams, device="cpu")
    for n, p in ttr.params.items():
        got_p, w = p.detach().numpy(), want_p[n].numpy()
        np.testing.assert_allclose(got_p, w, err_msg=n, **PARAM_TOL_ALL)
        far = ~np.isclose(got_p, w, **PARAM_TOL)
        assert far.mean() <= PARAM_FAR_SHARE, (n, int(far.sum()))
    assert float(ttr.last_ok) == 1.0
    if name == "top1":  # eval: the masked CE alone, as JAX's eval step
        np.testing.assert_allclose(ttr.evaluate(batches)["loss"],
                                   jtr.evaluate(batches)["loss"],
                                   **LOSS_TOL)


def test_convert_round_trips_moe_params_and_adam_state(top1_run):
    _, _, _, _, params, opt = top1_run
    tp = convert.from_jax_params(params, device="cpu")
    assert tp["layers.1.moe.w_gate"].shape == (4, 128, 256)
    back = convert.to_jax_params(tp)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree.structure(params) == jax.tree.structure(back)
    mine = convert.from_jax_opt_state(opt, device="cpu")
    assert mine["count"] == 3 and sorted(mine["mu"]) == sorted(tp)
    again = convert.to_jax_opt_state(mine, like=opt)
    for a, b in zip(jax.tree.leaves(opt), jax.tree.leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- decode and serving -----------------------------------------------------

@pytest.fixture(scope="module")
def serve_model():
    jcfg = jtfm.TransformerConfig(**SERVE_MODEL)
    tcfg = ttfm.TransformerConfig(**SERVE_MODEL)
    jp = jtfm.init(jax.random.key(2), jcfg)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


_ORACLE: dict = {}


def _jax_greedy(model, prompt, max_new):
    jcfg, _, jp, _ = model
    key = (prompt.tobytes(), prompt.shape, max_new)
    if key not in _ORACLE:
        _ORACLE[key] = np.asarray(jgen.generate(
            jp, jnp.asarray(prompt), jax.random.key(1), cfg=jcfg,
            max_new=max_new, temperature=0.0, decode_kernel=False))
    return _ORACLE[key]


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in (5, 19, 11)]


def test_generate_and_speculation_match_jax_greedy(serve_model):
    """The static paths: generate, generate_speculative (the model as its
    own draft) and generate_lookup, each equal to JAX's greedy stream."""
    _, tcfg, _, tp = serve_model
    prompt = np.stack([p[:5] for p in _prompts()])
    want = _jax_greedy(serve_model, prompt, 12)
    got = tgen.generate(tp, prompt, cfg=tcfg, max_new=12, temperature=0.0,
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    spec, st = tgen.generate_speculative(tp, tp, prompt, cfg=tcfg,
                                         draft_cfg=tcfg, max_new=12,
                                         n_spec=3, device="cpu")
    np.testing.assert_array_equal(spec.numpy(), want)
    assert st["accepted"] == st["drafted"] > 0
    look, _ = tgen.generate_lookup(tp, prompt, cfg=tcfg, max_new=12,
                                   n_spec=3, device="cpu")
    np.testing.assert_array_equal(look.numpy(), want)


@pytest.mark.parametrize("kw", [dict(), dict(paged=True, max_len=1024),
                                dict(speculate=3, steps_per_sync=4)],
                         ids=["dense", "paged", "speculate"])
def test_batcher_matches_jax_greedy(serve_model, kw):
    """Three ragged requests through two slots at the batcher's defaults
    (in-block refill, overlap): each request's tokens equal JAX's static
    greedy generate."""
    _, tcfg, _, tp = serve_model
    kw = dict(dict(max_len=512, prompt_buckets=(32,)), **kw)
    cb = ContinuousBatcher(tp, tcfg, slots=2, temperature=0.0,
                           device="cpu", **kw)
    prompts = _prompts()
    got = cb.run(prompts, max_new=10)
    for rid, p in enumerate(prompts):
        np.testing.assert_array_equal(got[rid],
                                      _jax_greedy(serve_model, p[None],
                                                  10)[0])


def test_expert_choice_decode_warns(serve_model):
    """Decoding an expert-choice model approximates it with capacity-free
    token choice, and says so, in both packages."""
    jcfg, tcfg, jp, tp = serve_model
    ec = dataclasses.replace(tcfg, moe_router="experts", moe_top_k=1)
    jec = dataclasses.replace(jcfg, moe_router="experts", moe_top_k=1)
    prompt = _prompts()[0][None]
    with pytest.warns(UserWarning, match="expert-choice"):
        got = tgen.generate(tp, prompt, cfg=ec, max_new=4, temperature=0.0,
                            device="cpu")
    with pytest.warns(UserWarning, match="expert-choice"):
        want = jgen.generate(jp, jnp.asarray(prompt), jax.random.key(1),
                             cfg=jec, max_new=4, temperature=0.0,
                             decode_kernel=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("model_kw", [
    dict(n_experts=0, moe_dispatch_bits="int8"),
    dict(moe_dispatch_bits="int4"), dict(moe_a2a_chunks=2)],
    ids=["dense_with_bits", "local_bits", "local_chunks"])
def test_moe_config_checks_match_jax(model_kw):
    """The a2a knobs without an expert exchange are ValueErrors with the
    JAX messages; an expert or tensor axis that would carry them names
    slice 5d."""
    jcfg, tcfg = _models(**model_kw)
    with pytest.raises(ValueError) as want:
        jlm.validate_lm_cfg(jlm.LMTrainConfig(model=jcfg))
    with pytest.raises(ValueError) as got:
        tlm.validate_lm_cfg(tlm.LMTrainConfig(model=tcfg))
    assert str(got.value) == str(want.value)
    if model_kw.get("n_experts") != 0:
        for axis in ("ep", "tp"):
            with pytest.raises(NotImplementedError, match="slice 5d"):
                tlm.validate_lm_cfg(tlm.LMTrainConfig(model=tcfg,
                                                      **{axis: 2}))
