"""The port's MoE layer (distributed_pytorch_tpu_torch/ops/moe.py) against
the JAX package's ops/moe.py, on the CPU in float32.

The sizes are tests/test_moe.py's (E 8 experts, D 64, F 128, T 64 tokens):
the JAX ``moe_init`` weights from ``key(0)`` and normal tokens, carried
across as numpy.  Held:

- ``out`` and ``aux`` of ``moe_apply`` at rtol 1e-6, ``out`` with atol
  1e-6 beside it (its entries are O(1) sums of 64- and 128-term float32
  dot products, which XLA and torch add in different orders: a few 1e-7
  apart, so near-zero entries need the absolute term);
- the gradients of ``sum(sin(out)) + aux`` w.r.t. x and the four weights
  at rtol 1e-5 plus 1e-5 of each tensor's largest entry (the backward's
  sums run over the tokens too: the router's gradient sums 64 terms of
  ~1 into entries that may cancel to ~0.1);
- the index dispatch against the port's one-hot plain version
  (``moe_apply_plain``): bitwise in float32, out and aux, in every mode;
  and in bfloat16 for top-2, whose pair must add in float32 and round
  once (two bfloat16 adds differ: checked);
- the JAX value errors, with the same messages; an expert-parallel axis
  names slice 5d.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.ops import moe as jmoe
from distributed_pytorch_tpu_torch.ops import moe as tmoe

E, D, F, T = 8, 64, 128, 64
OUT_TOL = dict(rtol=1e-6, atol=1e-6)
AUX_TOL = dict(rtol=1e-6)
GRAD_RTOL = GRAD_OF_MAX = 1e-5
CASES = {
    "top1": dict(),
    "top2": dict(top_k=2),
    "experts": dict(router_mode="experts"),
    "z_loss": dict(z_coef=0.1),
    "drops": dict(capacity_factor=0.5),
    "top2_drops": dict(top_k=2, capacity_factor=0.5, z_coef=0.05),
    "capacity_clamp": dict(router_mode="experts", capacity_factor=100.0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(router_scale: float = 1.0):
    key = jax.random.key(0)
    params = {k: np.asarray(v) for k, v in
              jmoe.moe_init(key, D, F, E).items()}
    params["router"] = params["router"] * np.float32(router_scale)
    x = np.asarray(jax.random.normal(jax.random.fold_in(key, 9), (T, D)))
    return params, x


def _torch(params, x, dtype=torch.float32):
    return ({k: torch.tensor(v).requires_grad_(True)
             for k, v in params.items()},
            torch.tensor(x).to(dtype).requires_grad_(True))


def _jax_value_and_grads(params, x, kw):
    def f(p, xx):
        out, aux = jmoe.moe_apply(p, xx, n_experts=E, **kw)
        return jnp.sum(jnp.sin(out)) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return np.asarray(out), float(aux), {k: np.asarray(v)
                                         for k, v in gp.items()}, \
        np.asarray(gx)


@pytest.mark.parametrize("name", CASES)
def test_moe_apply_matches_jax(name):
    kw = CASES[name]
    params, x = _setup()
    want_out, want_aux, want_gp, want_gx = _jax_value_and_grads(params, x,
                                                                kw)
    tp, tx = _torch(params, x)
    out, aux = tmoe.moe_apply(tp, tx, n_experts=E, **kw)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **OUT_TOL)
    np.testing.assert_allclose(float(aux.detach()), want_aux, **AUX_TOL)
    (out.sin().sum() + aux).backward()
    for k, got, want in [("x", tx.grad, want_gx)] + [
            (k, tp[k].grad, g) for k, g in want_gp.items()]:
        np.testing.assert_allclose(got.numpy(), want, err_msg=k,
                                   rtol=GRAD_RTOL,
                                   atol=GRAD_OF_MAX * np.abs(want).max())


def test_drops_and_the_capacity_clamp():
    """cf 0.5 leaves each expert 4 slots for 64 tokens: the dropped
    tokens' rows are exactly zero on both sides, and the drop share the
    layer reports is theirs; a capacity factor of 100 is clamped to T, so
    every expert takes every token."""
    params, x = _setup()
    assert tmoe.capacity(T, E, 1, 0.5) == 4
    assert tmoe.capacity(T, E, 2, 0.5) == 8
    assert tmoe.capacity(T, E, 1, 100.0) == T
    assert tmoe.capacity(3, 8, 1, 0.1) == 1
    jout, _ = jmoe.moe_apply({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), n_experts=E,
                             capacity_factor=0.5)
    tp, tx = _torch(params, x)
    stats = {}
    out, _ = tmoe.moe_apply(tp, tx, n_experts=E, capacity_factor=0.5,
                            stats=stats)
    dropped_t = (out == 0).all(1).numpy()
    dropped_j = (np.asarray(jout) == 0).all(1)
    np.testing.assert_array_equal(dropped_t, dropped_j)
    assert int(stats["routed"]) - int(stats["kept"]) == dropped_t.sum() > 0
    assert int(stats["kept"]) <= E * 4
    stats = {}
    tmoe.moe_apply(tp, tx, n_experts=E, router_mode="experts",
                   capacity_factor=100.0, stats=stats)
    assert int(stats["kept"]) == int(stats["routed"]) == T


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_dispatch_equals_one_hot_plain(name, dtype):
    """The gathers and scatter-adds give the one-hot einsums' values bit
    for bit (f32), and in bf16 the same single rounding of each output."""
    kw = CASES[name]
    params, x = _setup()
    dt = getattr(torch, dtype)
    tp, tx = _torch(params, x, dt)
    with torch.no_grad():
        out, aux = tmoe.moe_apply(tp, tx, n_experts=E, **kw)
        want, want_aux = tmoe.moe_apply_plain(tp, tx, n_experts=E, **kw)
    assert out.dtype == want.dtype == dt
    assert torch.equal(out, want)
    assert float(aux) == float(want_aux)


def test_bf16_top2_pair_rounds_once():
    """Top-2 in bf16: the two gate-weighted expert rows are added in
    float32 and rounded once.  Adding them as two bf16 values differs
    somewhere on this input, so the bitwise plain comparison above has
    teeth."""
    params, x = _setup()
    tp, tx = _torch(params, x, torch.bfloat16)
    with torch.no_grad():
        out, _ = tmoe.moe_apply(tp, tx, n_experts=E, top_k=2)
        probs, _ = tmoe.route(tp, tx, 0.0)
        top_p, top_i = tmoe.top_k_stable(probs, 2)
        gates = (top_p / top_p.sum(-1, keepdim=True)).to(torch.bfloat16)
        cap = tmoe.capacity(T, E, 2, 2.0)
        slot, keep = tmoe.token_slots(top_i, E, cap)
        assert keep.all()
        xin = torch.zeros((E, cap, D), dtype=torch.bfloat16)
        for t in range(T):
            for k in range(2):
                xin[top_i[t, k], slot[t, k]] = tx[t]
        y = tmoe.expert_ffn(tp, xin)
        rows = [y[top_i[:, k], slot[:, k]] for k in range(2)]
        once = (gates[:, :1].float() * rows[0].float()
                + gates[:, 1:].float() * rows[1].float()).bfloat16()
        twice = (gates[:, :1] * rows[0]) + (gates[:, 1:] * rows[1])
    assert torch.equal(out, once)
    assert not torch.equal(out, twice)


def test_forced_tie_takes_the_lower_index_first():
    """A zero router gives every expert probability 1/E: lax.top_k takes
    the lowest indices first (expert 0, then 1; tokens 0..C-1 for every
    expert), and so must the port, or every output row would differ."""
    params, x = _setup(router_scale=0.0)
    for kw in (dict(), dict(top_k=2), dict(router_mode="experts"),
               dict(top_k=2, capacity_factor=0.5)):
        jout, jaux = jmoe.moe_apply(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            n_experts=E, **kw)
        tp, tx = _torch(params, x)
        out, aux = tmoe.moe_apply(tp, tx, n_experts=E, **kw)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   **OUT_TOL)
        np.testing.assert_allclose(float(aux.detach()), float(jaux),
                                   **AUX_TOL)
    v = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = tmoe.top_k_stable(v, 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(v.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


BAD = [dict(router_mode="random"), dict(top_k=3),
       dict(router_mode="experts", top_k=2), dict(dispatch_bits="fp8"),
       dict(dispatch_bits="int8"), dict(a2a_chunks=0), dict(a2a_chunks=2)]


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_value_errors_match_jax(kw):
    params, x = _setup()
    with pytest.raises(ValueError) as want:
        jmoe.moe_apply({k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x), n_experts=E, **kw)
    tp, tx = _torch(params, x)
    with pytest.raises(ValueError) as got:
        tmoe.moe_apply(tp, tx, n_experts=E, **kw)
    assert str(got.value) == str(want.value)


def test_expert_parallel_axis_names_slice_5d():
    params, x = _setup()
    tp, tx = _torch(params, x)
    with pytest.raises(NotImplementedError, match="slice 5d"):
        tmoe.moe_apply(tp, tx, n_experts=E, axis="model")
