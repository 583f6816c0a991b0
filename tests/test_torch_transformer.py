"""The port's transformer (distributed_pytorch_tpu_torch/models) against the
JAX package's, on the CPU in float32.

Weights come from the JAX ``tfm.init(jax.random.key(0))`` carried across by
convert.py; inputs are made with numpy from a seed.  Tolerance 1e-4
(atol and rtol): both sides compute in float32, in different summation
orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu.ops import attention as jattn
from distributed_pytorch_tpu.ops import quantized as jqz
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import generate as tgen
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from distributed_pytorch_tpu_torch.ops import attention as tattn
from distributed_pytorch_tpu_torch.ops import quantized as tqz
from distributed_pytorch_tpu_torch.serve import ContinuousBatcher

TOL = dict(atol=1e-4, rtol=1e-4)
SHAPE = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
             head_dim=32, d_ff=256)
CONFIGS = {"gqa": 2, "mha": None}


def _cfgs(kv):
    return (jtfm.TransformerConfig(**SHAPE, n_kv_heads=kv),
            ttfm.TransformerConfig(**SHAPE, n_kv_heads=kv))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jcfg, tcfg = _cfgs(CONFIGS[request.param])
    jp = jtfm.init(jax.random.key(0), jcfg)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal((64,)).astype(np.float32)
    want = np.asarray(jtfm.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = ttfm.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("pos_form", ["S", "BS"])
def test_rotary_matches_jax(pos_form):
    """Interleaved-pair rotary, with (S,) or per-sequence (B, S) positions."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 6, 32)).astype(np.float32)
    pos = (np.arange(6) + 7 if pos_form == "S"
           else rng.integers(0, 500, (2, 6))).astype(np.int32)
    want = np.asarray(jtfm.rotary(jnp.asarray(x), jnp.asarray(pos), 1e4))
    got = ttfm.rotary(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_apply_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(2).integers(0, 256, (2, 24)).astype(np.int32)
    want = np.asarray(jtfm.apply(jp, jnp.asarray(toks), cfg=jcfg,
                                 attn_impl="reference"))
    got = ttfm.apply(tp, torch.from_numpy(toks).long(), cfg=tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["plain", "causal", "bias", "lse"])
def test_attention_reference_matches_jax(mode):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
               for _ in range(3))
    kw = {}
    if mode == "causal":
        kw["causal"] = True
    if mode == "bias":
        kw["bias"] = np.where(rng.random((2, 1, 8, 8)) < 0.3, jattn.NEG_INF,
                              0.0).astype(np.float32)
        kw["bias"][..., 0] = 0.0  # every row keeps a live slot
    if mode == "lse":
        kw["with_lse"] = True
    want = jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: (jnp.asarray(a) if n == "bias" else a) for n, a in kw.items()})
    got = tattn.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **{n: (torch.from_numpy(a) if n == "bias" else a)
           for n, a in kw.items()})
    if mode == "lse":
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_shapes_and_scales():
    """The port's own init: the JAX layouts, shapes and scales."""
    jcfg, tcfg = _cfgs(2)
    tp = ttfm.init(0, tcfg, device="cpu")
    jp = jax.tree.map(np.asarray, jtfm.init(jax.random.key(0), jcfg))
    want = convert.from_jax_params(jp, device="cpu")
    assert sorted(tp) == sorted(want)
    for name, t in tp.items():
        assert t.shape == want[name].shape and t.dtype == torch.float32, name
    assert ttfm.param_count(tp) == sum(a.size for a in jax.tree.leaves(jp))
    assert abs(tp["embed"].std().item() - 0.02) < 2e-3
    assert abs(tp["layers.0.wq"].std().item() - 128 ** -0.5) < 0.01
    assert torch.equal(tp["final_norm"], torch.ones(128))
    again = ttfm.init(0, tcfg, device="cpu")
    assert all(torch.equal(again[n], tp[n]) for n in tp)


def test_convert_round_trip_is_exact(model):
    _, _, jp, tp = model
    back = convert.to_jax_params(tp)
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))
    flat_b = jax.tree_util.tree_flatten_with_path(back)
    assert [p for p, _ in flat_j[0]] == [p for p, _ in flat_b[0]]
    for (_, a), (_, b) in zip(flat_j[0], flat_b[0]):
        np.testing.assert_array_equal(a, b)
    again = convert.from_jax_params(back, device="cpu")
    assert all(torch.equal(again[n], tp[n]) for n in tp)


def test_presets_match_jax():
    assert sorted(ttfm.PRESETS) == sorted(jtfm.PRESETS)
    for name, jcfg in jtfm.PRESETS.items():
        tcfg = ttfm.PRESETS[name]
        for f in ("vocab_size", "d_model", "n_layers", "n_heads", "kv_heads",
                  "head_dim", "ff", "rope_theta", "norm_eps"):
            assert getattr(tcfg, f) == getattr(jcfg, f), (name, f)


def test_config_validation_matches_jax():
    for kw in (dict(n_heads=4, n_kv_heads=3), dict(moe_dispatch_bits="fp8"),
               dict(moe_a2a_chunks=0)):
        with pytest.raises(ValueError):
            jtfm.TransformerConfig(**kw)
        with pytest.raises(ValueError):
            ttfm.TransformerConfig(**kw)


REFUSED_APPLY = [dict(attn_impl="flash"), dict(seq_axis="seq"),
                 dict(tp_axis="model"), dict(ep_axis="expert"),
                 dict(remat="full"), dict(boundary=lambda g, p: p),
                 dict(matmul_dtype="int8")]


def _int8_products(jp, jcfg, toks):
    """The JAX int8 forward's logits and, for each of its int8 products,
    the operands and output it computed (recorded eagerly)."""
    calls, orig = [], jqz.quantized_matmul

    def record(x, w, *args):
        out = orig(x, w, *args)
        calls.append(tuple(np.array(a) for a in (x, w, out)))
        return out

    jqz.quantized_matmul = record
    try:
        logits = jtfm.apply(jp, jnp.asarray(toks, jnp.int32), cfg=jcfg,
                            attn_impl="flash", matmul_dtype="int8")
    finally:
        jqz.quantized_matmul = orig
    return np.asarray(logits), calls


def _check_int8_apply(jcfg, tcfg, jp, tp):
    """``apply(matmul_dtype="int8")`` against the JAX package's.

    Product by product on identical inputs it is bitwise: each of the 7 x
    n_layers int8 products, given the JAX forward's own operands, returns
    the JAX output bit for bit.  Whole-model, the port's activations differ
    from JAX's by float32 ulps (rms_norm, silu, attention), and a value an
    ulp from a rounding boundary then quantizes one quantum apart; so the
    logits are held within twice the JAX package's own spread when its
    embedding moves by one ulp (four random sign patterns), plus 1e-4."""
    toks = np.random.default_rng(4).integers(0, 256, (2, 24))
    want, calls = _int8_products(jp, jcfg, toks)
    assert len(calls) == 7 * jcfg.n_layers
    for x, w, out in calls:
        got = tqz.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_array_equal(got.numpy(), out)
    got = ttfm.apply(tp, torch.from_numpy(toks), cfg=tcfg,
                     matmul_dtype="int8").detach().numpy()
    embed = np.asarray(jp["embed"])
    spread = 0.0
    for seed in range(4):
        sign = np.random.default_rng(seed).choice([-1, 1], embed.shape)
        moved = dict(jp, embed=jnp.asarray(np.nextafter(
            embed, embed + sign.astype(np.float32))))
        spread = max(spread, np.abs(_int8_products(moved, jcfg, toks)[0]
                                    - want).max())
    assert np.abs(got - want).max() <= 2 * spread + 1e-4
    plain = ttfm.apply(tp, torch.from_numpy(toks), cfg=tcfg).detach()
    assert not np.allclose(got, plain.numpy(), atol=1e-3)  # int8 ran


@pytest.mark.parametrize("kw", REFUSED_APPLY,
                         ids=[next(iter(k)) for k in REFUSED_APPLY])
def test_apply_refuses_unported_options(model, kw):
    """Options of later slices raise, naming their ROADMAP slice.  Four are
    ported now and are held against the JAX package's apply on the CPU
    instead: ``attn_impl="flash"`` (Pallas in interpret mode), ``remat``
    (the forward of each rematerialized layer is the layer's, and the
    gradients equal the plain apply's), ``matmul_dtype="int8"``
    (``_check_int8_apply``) and ``boundary`` (the sync knobs' layer-group
    hook: called at JAX's groups in JAX's order, an identity, the logits
    JAX's)."""
    jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(4).integers(0, 256, (2, 24))
    if kw == dict(attn_impl="flash"):
        want = np.asarray(jtfm.apply(jp, jnp.asarray(toks, jnp.int32),
                                     cfg=jcfg, attn_impl="flash"))
        got = ttfm.apply(tp, torch.from_numpy(toks), cfg=tcfg, **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        return
    if "remat" in kw:
        want = np.asarray(jtfm.apply(jp, jnp.asarray(toks, jnp.int32),
                                     cfg=jcfg, **kw))
        grads = []
        for remat in (None, kw["remat"]):
            leaves = {n: p.clone().requires_grad_(True)
                      for n, p in tp.items()}
            got = ttfm.apply(leaves, torch.from_numpy(toks), cfg=tcfg,
                             remat=remat)
            np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
            got.square().mean().backward()
            grads.append({n: p.grad for n, p in leaves.items()})
        for n in tp:
            torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6,
                                       atol=1e-7)
        return
    if "matmul_dtype" in kw:
        _check_int8_apply(jcfg, tcfg, jp, tp)
        return
    if "boundary" in kw:
        seen = {"jax": [], "port": []}

        def hook(side):
            return lambda group, p: seen[side].append(group) or p

        want = np.asarray(jtfm.apply(jp, jnp.asarray(toks, jnp.int32),
                                     cfg=jcfg, boundary=hook("jax")))
        got = ttfm.apply(tp, torch.from_numpy(toks), cfg=tcfg,
                         attn_impl="reference", boundary=hook("port"))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert seen["port"] == seen["jax"] == list(range(
            tcfg.n_layers + 2))
        assert sorted(ttfm.sync_group_index(tcfg).items()) == sorted(
            jtfm.sync_group_index(jcfg).items())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttfm.apply(tp, torch.zeros((1, 4), dtype=torch.long), cfg=tcfg, **kw)


def test_apply_rejects_bad_knob_values(model):
    """Values neither package takes are ValueErrors, as in JAX."""
    _, tcfg, _, tp = model
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="matmul_dtype"):
        ttfm.apply(tp, toks, cfg=tcfg, matmul_dtype="int4")
    with pytest.raises(ValueError, match="remat"):
        ttfm.apply(tp, toks, cfg=tcfg, remat="some")


def test_moe_config_is_refused():
    """Refused until slice 6b; ported now.  An MoE config (4 experts, top-2,
    layer 1 MoE): the port's init has the JAX tree's names, shapes and
    scales; on the JAX weights (convert.py) the port's apply equals the JAX
    apply, logits at the module's tolerance and the summed aux at 1e-6."""
    kw = dict(n_experts=4, moe_top_k=2)
    jcfg = jtfm.TransformerConfig(**SHAPE, **kw)
    tcfg = ttfm.TransformerConfig(**SHAPE, **kw)
    tp = ttfm.init(0, tcfg, device="cpu")
    jp = jax.tree.map(np.asarray, jtfm.init(jax.random.key(0), jcfg))
    want = convert.from_jax_params(jp, device="cpu")
    assert sorted(tp) == sorted(want) and "layers.1.moe.router" in tp
    assert "layers.1.w_gate" not in tp and "layers.0.w_gate" in tp
    for name, t in tp.items():
        assert t.shape == want[name].shape, name
    assert abs(tp["layers.1.moe.w_down"].std().item() - 256 ** -0.5) < 0.01
    toks = np.random.default_rng(5).integers(0, 256, (2, 24))
    jlog, jaux = jtfm.apply(jax.tree.map(jnp.asarray, jp),
                            jnp.asarray(toks, jnp.int32), cfg=jcfg,
                            attn_impl="reference", return_aux=True)
    got, aux = ttfm.apply(want, torch.from_numpy(toks), cfg=tcfg,
                          attn_impl="reference", return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert float(aux) > 0


def test_entry_points_refuse_cpu_by_default(monkeypatch, model):
    """With no GPU, an entry point left at its default device raises; it
    never runs on the CPU unless asked."""
    _, tcfg, jp, tp = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttfm.init(0, tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgen.generate(tp, np.zeros((1, 4), np.int32), cfg=tcfg, max_new=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatcher(tp, tcfg, slots=1, max_len=512)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.from_jax_params(jax.tree.map(np.asarray, jp))
