"""The port's flash attention (distributed_pytorch_tpu_torch/ops/attention.py)
against the JAX package's Pallas ``flash_attention``, which runs in
interpret mode on the CPU as tests/test_attention.py runs it, at that
file's shapes and blocks (B=2, H=2, S=256, D=64, blocks of 128).

Inputs are made with numpy from a seed.  Both sides compute in float32 and
sum in different orders: outputs and lse to 2e-5, gradients to 1e-4 (atol
and rtol), the JAX tests' own tolerances.  On CPU tensors the port's
autograd.Function runs the plain versions; the CUDA kernels (K2, K3, K4)
are held against those plain versions on the card by the ``cuda``-marked
tests at the end, which skip without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.ops import attention as jattn
from distributed_pytorch_tpu_torch.ops import attention as tattn

B, H, S, D = 2, 2, 256, 64
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _qkv(seed=0, s=S, d=D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, s, d)).astype(np.float32)
                 for _ in range(3))


def _jax_flash(q, k, v, **kw):
    return jattn.flash_attention(q, k, v, block_q=128, block_k=128, **kw)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(causal):
    q, k, v = _qkv()
    want = _jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=causal)
    assert got.shape == (B, H, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_matches_jax(causal):
    q, k, v = _qkv(1)
    o_j, lse_j = _jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                            with_lse=True)
    o_t, lse_t = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal, with_lse=True)
    assert lse_t.shape == (B, H, S) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **FWD_TOL)


def _loss_j(with_lse):
    def f(q, k, v, causal):
        if with_lse:
            o, lse = _jax_flash(q, k, v, causal=causal, with_lse=True)
            return jnp.sum(jnp.sin(o)) + jnp.sum(jnp.cos(lse))
        return jnp.sum(jnp.sin(_jax_flash(q, k, v, causal=causal)))
    return f


def _grads_t(q, k, v, causal, with_lse):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    if with_lse:
        o, lse = tattn.flash_attention(qt, kt, vt, causal=causal,
                                       with_lse=True)
        loss = torch.sin(o).sum() + torch.cos(lse).sum()
    else:
        loss = torch.sin(tattn.flash_attention(qt, kt, vt,
                                               causal=causal)).sum()
    loss.backward()
    return qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("with_lse", [False, True], ids=["o", "o+lse"])
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax(causal, with_lse):
    """Gradients of sum(sin(o)), and of sum(sin(o)) + sum(cos(lse)) (a
    nonzero lse cotangent, folded into delta)."""
    q, k, v = _qkv(2)
    want = jax.grad(_loss_j(with_lse), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)), causal)
    got = _grads_t(q, k, v, causal, with_lse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_autograd_of_reference(causal):
    """``flash_attention_bwd_plain`` (the K3/K4 formulas, p recomputed from
    the saved lse) against torch autograd through ``attention_reference``,
    with an lse cotangent too, on (B*H, S, D) operands."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((4, 128, 64)).astype(np.float32))
        for _ in range(4))
    dlse = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    o, lse = tattn.attention_reference(qr, kr, vr, causal=causal,
                                       with_lse=True)
    torch.autograd.backward((o, lse), (do, dlse))
    delta = (do * o.detach()).sum(-1) - dlse
    got = tattn.flash_attention_bwd_plain(q, k, v, lse.detach(), do, delta,
                                          causal=causal)
    for g, w in zip(got, (qr.grad, kr.grad, vr.grad)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


def test_argument_refusals_match_jax():
    """Rank, block divisibility, causal sq == sk, and lengths with no
    8-aligned divisor >= 128: the JAX function's refusals."""
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    with pytest.raises(ValueError, match="B, H, S, D"):
        tattn.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="divide"):
        tattn.flash_attention(q, k, v, block_q=96)
    with pytest.raises(ValueError, match="causal"):
        tattn.flash_attention(q[:, :, :128], k, v, causal=True)
    with pytest.raises(ValueError, match="8-aligned"):
        tattn.flash_attention(q[:, :, :100], k[:, :, :100], v[:, :, :100])
    assert (tattn.DEFAULT_BLOCK_Q, tattn.DEFAULT_BLOCK_K) == \
        (jattn.DEFAULT_BLOCK_Q, jattn.DEFAULT_BLOCK_K)
    for s in (192, 256, 1024, 1536, 8 * 17):
        assert tattn._fit_block(tattn.DEFAULT_BLOCK_Q, s) == \
            jattn._fit_block(jattn.DEFAULT_BLOCK_Q, s)


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    q, k, v = (torch.from_numpy(a[0]) for a in _qkv(4))
    before = [f.launches for f in (tattn.flash_attention_fwd,
                                   tattn.flash_attention_bwd_dq,
                                   tattn.flash_attention_bwd_dkv)]
    o, lse = tattn.flash_attention_fwd(q, k, v, causal=True)
    want_o, want_lse = tattn.flash_attention_fwd_plain(q, k, v, causal=True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    delta = (o * o).sum(-1)
    dq = tattn.flash_attention_bwd_dq(q, k, v, lse, o, delta, causal=True)
    dk, dv = tattn.flash_attention_bwd_dkv(q, k, v, lse, o, delta,
                                           causal=True)
    want = tattn.flash_attention_bwd_plain(q, k, v, lse, o, delta,
                                           causal=True)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), want))
    assert [f.launches for f in (tattn.flash_attention_fwd,
                                 tattn.flash_attention_bwd_dq,
                                 tattn.flash_attention_bwd_dkv)] == before


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the flash kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal,s", [
    (torch.float32, 64, True, 256), (torch.float32, 128, False, 200),
    (torch.bfloat16, 128, True, 1024), (torch.bfloat16, 64, False, 256)])
def test_kernels_match_plain_on_card(cuda, dtype, d, causal, s):
    """K2, K3 and K4 against their plain versions on the same inputs:
    float32 to 1e-4 (summation order), bf16 to 5% of the reference's RMS
    plus one bf16 ulp of each element (both sides round p, ds and their
    outputs to bf16 at different points)."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (4, s, d)).astype(np.float32)).to(cuda, dtype) for _ in range(4))
    o, lse = tattn.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = tattn.flash_attention_fwd_plain(q, k, v, causal=causal)
    delta = (do.float() * ro.float()).sum(-1)
    dq = tattn.flash_attention_bwd_dq(q, k, v, rlse, do, delta,
                                      causal=causal)
    dk, dv = tattn.flash_attention_bwd_dkv(q, k, v, rlse, do, delta,
                                           causal=causal)
    want = tattn.flash_attention_bwd_plain(q, k, v, rlse, do, delta,
                                           causal=causal)
    torch.cuda.synchronize()
    for got, ref in zip((o, lse, dq, dk, dv), (ro, rlse, *want)):
        err = (got.float() - ref.float()).abs()
        if dtype == torch.float32 or got is lse:
            tol = 1e-4 + 1e-4 * ref.float().abs()
        else:
            tol = 0.05 * ref.float().pow(2).mean().sqrt() \
                + 2 ** -7 * ref.float().abs()
        assert bool((err <= tol).all()), err.max().item()


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((2, 128, 96), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention_fwd(q, q, q)
    q = torch.zeros((2, 128, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tattn.flash_attention_fwd(q, q, q)
