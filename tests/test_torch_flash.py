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

The bf16 forward kernel (``fwd_sm90_kernel`` in csrc/flash_attention.cu)
has its own numeric recipe: 128-key tiles in ascending order for 64-row
query halves, scores scaled into base 2, p rounded to bf16 per tile, the
mask applied on diagonal and Sk-edge tiles only, o times 1/l.
``_recipe_fwd`` replays it in numpy, and it is held against the Pallas
kernel on bf16 inputs within chip_smoke.py's bf16 FLASH_TOL, before any
card runs it.  The bf16 backward kernels (``bwd_dq_sm90_kernel``,
``bwd_dkv_sm90_kernel``) are replayed the same way by ``_recipe_bwd_dq``
and ``_recipe_bwd_dkv`` and held against the Pallas VJP.
"""

import re
from pathlib import Path

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


# -- the bf16 forward kernel's recipe, on the CPU ---------------------------

CSRC = Path(tattn.__file__).resolve().parent.parent / "csrc"
# chip_smoke.py's FLASH_TOL for bf16: o within min(1e-2, 5% of its row's
# RMS) plus one bf16 ulp of the element; lse (f32 on both sides) 1e-3.
BF16_O_ABS, BF16_O_ROW_RMS, BF16_LSE, BF16_ULP = 1e-2, 5e-2, 1e-3, 2.0 ** -7


def _bf16(x):
    """float32 rounded to the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _kernel_tiles(names=("kFwdM", "kFwdN")):
    """Tile constants of csrc/flash_attention.cu, read from the source so a
    replay follows its kernel: by default fwd_sm90_kernel's (query rows per
    work tile, key rows per tile)."""
    src = (CSRC / "flash_attention.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)
                     .group(1)) for name in names)


def _bwd_tiles():
    """(rows per work tile, rows per streamed tile) of bwd_dq_sm90_kernel
    (query rows, key rows) and bwd_dkv_sm90_kernel (key rows, query
    rows)."""
    return _kernel_tiles(("kBwdM", "kBwdN"))


def _recipe_fwd(q, k, v, *, causal, sm_scale):
    """fwd_sm90_kernel's arithmetic in numpy float32 on (BH, S, D) bf16
    values: per 64-row half of each query tile, key tiles in ascending
    order (causal: only up to the diagonal), s = q.k in f32, masked to
    -1e30 on tiles that cross the diagonal or Sk, m = max(m, max(s) *
    scale log2 e), p = exp2(s * scale log2 e - m) (one rounding, as the
    FMA), l = l * alpha + sum(p), o = o * alpha + bf16(p) . v, then o
    times 1/max(l, 1e-30) to bf16 and lse = m ln 2 + log(max(l, 1e-30))."""
    bm, bn = _kernel_tiles()
    half = bm // 2
    bh, sq, d = q.shape
    sk = k.shape[1]
    c = np.float32(sm_scale * np.log2(np.e))
    o_out = np.zeros((bh, sq, d), np.float32)
    lse_out = np.zeros((bh, sq), np.float32)
    n_k = -(-sk // bn)
    pad = n_k * bn - sk
    kp = np.pad(k, ((0, 0), (0, pad), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, pad), (0, 0)))
    for b in range(bh):
        for q0 in range(0, sq, bm):
            n = min(n_k, (q0 + bm - 1) // bn + 1) if causal else n_k
            for qw in (q0, q0 + half):
                rows = np.arange(qw, qw + half)
                qt = np.zeros((half, d), np.float32)
                live = rows[rows < sq]
                qt[:len(live)] = q[b, live]
                m = np.full(half, -1e30, np.float32)
                l = np.zeros(half, np.float32)
                acc = np.zeros((half, d), np.float32)
                for j in range(n):
                    k0 = j * bn
                    s = qt @ kp[b, k0:k0 + bn].T
                    if k0 + bn > sk or (causal and k0 + bn - 1 > qw):
                        kj = np.arange(k0, k0 + bn)[None, :]
                        masked = (kj >= sk) | (causal & (kj > rows[:, None]))
                        s = np.where(masked, np.float32(-1e30), s)
                    mx = np.maximum(m, s.max(1) * c)
                    alpha = np.exp2(m - mx)
                    p = np.exp2((s.astype(np.float64) * c
                                 - mx[:, None]).astype(np.float32))
                    l = l * alpha + p.sum(1, dtype=np.float32)
                    acc = acc * alpha[:, None] + _bf16(p) @ vp[b, k0:k0 + bn]
                    m = mx
                safe = np.maximum(l, np.float32(1e-30))
                out = _bf16(acc * (np.float32(1) / safe)[:, None])
                lse = m * np.float32(np.log(2)) + np.log(safe)
                o_out[b, live] = out[:len(live)]
                lse_out[b, live] = lse[:len(live)]
    return o_out, lse_out


LOG2E = np.float32(np.log2(np.e))


def _exp2_fma(s, c, l):
    """exp2(s * c - l) with the product and the difference rounded once,
    as the kernels' fmaf."""
    return np.exp2((s.astype(np.float64) * np.float64(c)
                    - np.asarray(l, np.float64)).astype(np.float32))


def _recipe_bwd_dq(q, k, v, do, lse, delta, *, causal, sm_scale):
    """bwd_dq_sm90_kernel's arithmetic in numpy float32 on (BH, S, D) bf16
    values: per 64-row half of each 128-row query tile, 64-key tiles in
    ascending order (causal: only up to the half's diagonal), s = q.k and
    dp = do.v in f32, s masked to -1e30 on tiles that cross the half's
    diagonal or Sk, p = exp2(s * scale log2 e - lse log2 e) (one rounding,
    as the FMA), ds = p (dp - delta) scale rounded to bf16 per tile, dq +=
    bf16(ds) . k, and dq to bf16."""
    bm, bn = _bwd_tiles()
    half = bm // 2
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = np.float32(sm_scale)
    c = scale * LOG2E
    n_k = -(-sk // bn)
    kp, vp = (np.pad(a, ((0, 0), (0, n_k * bn - sk), (0, 0))) for a in (k, v))
    dq = np.zeros((bh, sq, d), np.float32)
    for b in range(bh):
        for qw in range(0, sq, half):  # each query tile's two halves
            rows = np.arange(qw, qw + half)
            live = rows[rows < sq]
            qt, dot = (np.zeros((half, d), np.float32) for _ in range(2))
            qt[:len(live)], dot[:len(live)] = q[b, live], do[b, live]
            l, dl = (np.zeros(half, np.float32) for _ in range(2))
            l[:len(live)] = lse[b, live] * LOG2E
            dl[:len(live)] = delta[b, live]
            n = min(n_k, (qw + half - 1) // bn + 1) if causal else n_k
            acc = np.zeros((half, d), np.float32)
            for j in range(n):
                k0 = j * bn
                kt, vt = kp[b, k0:k0 + bn], vp[b, k0:k0 + bn]
                s = qt @ kt.T
                if k0 + bn > sk or (causal and k0 + bn - 1 > qw):
                    kj = np.arange(k0, k0 + bn)[None, :]
                    masked = (kj >= sk) | (causal & (kj > rows[:, None]))
                    s = np.where(masked, np.float32(-1e30), s)
                p = _exp2_fma(s, c, l[:, None])
                ds = p * (dot @ vt.T - dl[:, None]) * scale
                acc = acc + _bf16(ds) @ kt
            dq[b, live] = _bf16(acc)[:len(live)]
    return dq


def _recipe_bwd_dkv(q, k, v, do, lse, delta, *, causal, sm_scale):
    """bwd_dkv_sm90_kernel's arithmetic in numpy float32 on (BH, S, D) bf16
    values: per 64-row half of each 128-row key tile, 64-query tiles in
    ascending order (causal: from the half's diagonal on), s^T = k.q and
    dp^T = v.do in f32, s^T masked to -1e30 on tiles that cross Sq, Sk or
    the diagonal, p^T = exp2(s^T scale log2 e - lse log2 e), ds^T = p^T
    (dp^T - delta) scale, dv += bf16(p^T) . do and dk += bf16(ds^T) . q,
    and dk, dv to bf16."""
    bm, bn = _bwd_tiles()
    half = bm // 2
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = np.float32(sm_scale)
    c = scale * LOG2E
    n_q = -(-sq // bn)
    pad = ((0, 0), (0, n_q * bn - sq))
    qp, dop = (np.pad(a, pad + ((0, 0),)) for a in (q, do))
    lp, dlp = np.pad(lse, pad) * LOG2E, np.pad(delta, pad)
    dk_out, dv_out = (np.zeros((bh, sk, d), np.float32) for _ in range(2))
    for b in range(bh):
        for kw in range(0, sk, half):  # each key tile's two halves
            rows = np.arange(kw, kw + half)
            live = rows[rows < sk]
            kt, vt = (np.zeros((half, d), np.float32) for _ in range(2))
            kt[:len(live)], vt[:len(live)] = k[b, live], v[b, live]
            dk, dv = (np.zeros((half, d), np.float32) for _ in range(2))
            for t in range(kw // bn if causal else 0, n_q):
                i0 = t * bn
                qt, dot = qp[b, i0:i0 + bn], dop[b, i0:i0 + bn]
                s = kt @ qt.T
                if i0 + bn > sq or kw + half > sk or \
                        (causal and kw + half - 1 > i0):
                    qi = np.arange(i0, i0 + bn)[None, :]
                    kj = rows[:, None]
                    masked = (qi >= sq) | (kj >= sk) | (causal & (kj > qi))
                    s = np.where(masked, np.float32(-1e30), s)
                p = _exp2_fma(s, c, lp[b, None, i0:i0 + bn])
                ds = p * (vt @ dot.T - dlp[b, None, i0:i0 + bn]) * scale
                dv = dv + _bf16(p) @ dot
                dk = dk + _bf16(ds) @ qt
            dk_out[b, live] = _bf16(dk)[:len(live)]
            dv_out[b, live] = _bf16(dv)[:len(live)]
    return dk_out, dv_out


# chip_smoke.py's FLASH_TOL for bf16 gradients: each within 5% of the
# reference's RMS over its (b*h) slab plus one bf16 ulp of the element.
BF16_GRAD_SLAB_RMS = 5e-2


def _hold_bf16_grads(got, want):
    """chip_smoke.py's bf16 FLASH_TOL for dq, dk and dv (each (BH, S, D))
    against the reference."""
    for g, w in zip(got, want):
        err = np.abs(g - w)
        rms = np.sqrt((w ** 2).mean(axis=(-2, -1), keepdims=True))
        bound = BF16_GRAD_SLAB_RMS * rms + BF16_ULP * np.abs(w)
        assert (err <= bound).all(), float((err / bound).max())


def _hold_bf16(o, lse, want_o, want_lse):
    """chip_smoke.py's bf16 FLASH_TOL: o and lse against the reference."""
    err = np.abs(o - want_o)
    rms = np.sqrt((want_o ** 2).mean(-1, keepdims=True))
    bound = np.minimum(BF16_O_ABS, BF16_O_ROW_RMS * rms) \
        + BF16_ULP * np.abs(want_o)
    assert (err <= bound).all(), float((err / bound).max())
    np.testing.assert_allclose(lse, want_lse, atol=BF16_LSE, rtol=0)


def test_bf16_rounding_helper_matches_torch():
    x = np.random.default_rng(9).standard_normal(4096).astype(np.float32)
    x[:4] = (1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -2.5, 0.0)  # ties, exact
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(_bf16(x), want)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [128, 384])
def test_bf16_kernel_recipe_matches_jax(s, d, causal):
    """The bf16 forward kernel's recipe, replayed in numpy, against the
    Pallas kernel in interpret mode on the same bf16 inputs (B=1, H=2,
    blocks of 128)."""
    rng = np.random.default_rng(11)
    q, k, v = (_bf16(rng.standard_normal((1, 2, s, d)).astype(np.float32))
               for _ in range(3))
    o_j, lse_j = _jax_flash(*(jnp.asarray(a, jnp.bfloat16)
                              for a in (q, k, v)), causal=causal,
                            with_lse=True)
    o_r, lse_r = _recipe_fwd(*(a.reshape(2, s, d) for a in (q, k, v)),
                             causal=causal, sm_scale=1 / np.sqrt(d))
    _hold_bf16(o_r, lse_r, np.asarray(o_j, np.float32).reshape(2, s, d),
               np.asarray(lse_j, np.float32).reshape(2, s))


def test_recipe_reads_the_kernel_tiles():
    """The replay's tiles are the kernel's: 128 query rows in two 64-row
    warpgroup halves, 128-key tiles; and a ragged, non-causal Sq != Sk case
    agrees with the plain forward (which the JAX kernel does not take)."""
    assert _kernel_tiles() == (128, 128)
    rng = np.random.default_rng(12)
    q = _bf16(rng.standard_normal((2, 200, 64)).astype(np.float32))
    k, v = (_bf16(rng.standard_normal((2, 333, 64)).astype(np.float32))
            for _ in range(2))
    o_r, lse_r = _recipe_fwd(q, k, v, causal=False, sm_scale=0.125)
    o_p, lse_p = tattn.flash_attention_fwd_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        sm_scale=0.125)
    _hold_bf16(o_r, lse_r, o_p.float().numpy(), lse_p.numpy())


def _jax_bwd(q, k, v, do, dlse, causal):
    """The JAX package's flash_attention VJP (Pallas in interpret mode,
    blocks of 128) on bf16 (B, H, S, D) values: (dq, dk, dv) as float32,
    and the forward's lse and the backward's delta = rowsum(do * o) - dlse
    that the kernels are given.  Without ``dlse`` the VJP is the o-only
    one; with it, the (o, lse) one with that lse cotangent."""
    qj, kj, vj, doj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    o, lse = _jax_flash(qj, kj, vj, causal=causal, with_lse=True)
    delta = jnp.sum(doj.astype(jnp.float32) * o.astype(jnp.float32), -1)
    if dlse is None:
        _, vjp = jax.vjp(lambda *a: _jax_flash(*a, causal=causal), qj, kj,
                         vj)
        grads = vjp(doj)
    else:
        _, vjp = jax.vjp(lambda *a: _jax_flash(*a, causal=causal,
                                               with_lse=True), qj, kj, vj)
        grads = vjp((doj, jnp.asarray(dlse, jnp.float32)))
        delta = delta - jnp.asarray(dlse, jnp.float32)
    return ([np.asarray(g, np.float32) for g in grads],
            np.asarray(lse, np.float32), np.asarray(delta, np.float32))


BWD_RECIPE_CASES = [(s, d, causal, False) for s in (128, 384)
                    for d in (64, 128) for causal in (False, True)] \
    + [(256, 64, True, True)]


@pytest.mark.parametrize(
    "s,d,causal,with_lse", BWD_RECIPE_CASES,
    ids=[f"s{c[0]}-d{c[1]}-{'causal' if c[2] else 'full'}"
         + ("-lse" if c[3] else "") for c in BWD_RECIPE_CASES])
def test_bf16_bwd_recipes_match_jax(s, d, causal, with_lse):
    """The bf16 backward kernels' recipes (K3's dq, K4's dk and dv),
    replayed in numpy, against the Pallas VJP in interpret mode on the same
    bf16 inputs (B=1, H=2, blocks of 128), given its lse and delta, within
    chip_smoke.py's bf16 gradient tolerance: 5% of the reference's RMS over
    its (b*h) slab plus one bf16 ulp of the element."""
    rng = np.random.default_rng(13 + s + d)
    q, k, v, do = (_bf16(rng.standard_normal((1, 2, s, d)).astype(np.float32))
                   for _ in range(4))
    dlse = rng.standard_normal((1, 2, s)).astype(np.float32) \
        if with_lse else None
    want, lse, delta = _jax_bwd(q, k, v, do, dlse, causal)
    args = [a.reshape(2, s, d) for a in (q, k, v, do)] \
        + [lse.reshape(2, s), delta.reshape(2, s)]
    kw = dict(causal=causal, sm_scale=1 / np.sqrt(d))
    got = (_recipe_bwd_dq(*args, **kw), *_recipe_bwd_dkv(*args, **kw))
    _hold_bf16_grads(got, [w.reshape(2, s, d) for w in want])


def test_bwd_recipes_read_the_kernel_tiles():
    """The backward replays' tiles are the kernels': 128-row work tiles in
    two 64-row warpgroup halves, 64-row streamed tiles; and a ragged,
    non-causal Sq != Sk case (which the JAX kernel does not take) agrees
    with ``flash_attention_bwd_plain``."""
    assert _bwd_tiles() == (128, 64)
    rng = np.random.default_rng(14)
    q, do = (_bf16(rng.standard_normal((2, 200, 64)).astype(np.float32))
             for _ in range(2))
    k, v = (_bf16(rng.standard_normal((2, 333, 64)).astype(np.float32))
            for _ in range(2))
    qt, kt, vt, dot = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    o, lse = tattn.flash_attention_fwd_plain(qt, kt, vt, sm_scale=0.125)
    delta = (dot.float() * o.float()).sum(-1)
    want = tattn.flash_attention_bwd_plain(qt, kt, vt, lse, dot, delta,
                                           sm_scale=0.125)
    args = (q, k, v, do, lse.numpy(), delta.numpy())
    got = (_recipe_bwd_dq(*args, causal=False, sm_scale=0.125),
           *_recipe_bwd_dkv(*args, causal=False, sm_scale=0.125))
    _hold_bf16_grads(got, [w.float().numpy() for w in want])


# -- the bf16 kernels on the card -------------------------------------------

EDGE_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 1000, 2048)
EDGE_CASES = [(1 if s <= 129 else 64 if s == 1000 else 8, s, s, d, causal)
              for s in EDGE_LENGTHS for d in (64, 128)
              for causal in (False, True)] \
    + [(8, 256, 1000, d, False) for d in (64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d,causal", EDGE_CASES,
                         ids=[f"bh{c[0]}-{c[1]}x{c[2]}-d{c[3]}-"
                              f"{'causal' if c[4] else 'full'}"
                              for c in EDGE_CASES])
def test_bf16_kernel_tile_edges_on_card(cuda, bh, sq, sk, d, causal):
    """K2's bf16 kernel against ``flash_attention_fwd_plain`` at the tile
    edges (lengths around 64 and 128, one row, long rows, Sq != Sk), BH 1
    to 64, D 64 and 128, within the bf16 FLASH_TOL; two runs bitwise
    equal."""
    gen = torch.Generator(device=cuda).manual_seed(sq * 7 + sk + d)
    q = torch.randn((bh, sq, d), generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn((bh, sk, d), generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    o, lse = tattn.flash_attention_fwd(q, k, v, causal=causal)
    o2, lse2 = tattn.flash_attention_fwd(q, k, v, causal=causal)
    want_o, want_lse = tattn.flash_attention_fwd_plain(q, k, v,
                                                       causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _hold_bf16(o.float().cpu().numpy(), lse.cpu().numpy(),
               want_o.float().cpu().numpy(), want_lse.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d,causal", EDGE_CASES,
                         ids=[f"bh{c[0]}-{c[1]}x{c[2]}-d{c[3]}-"
                              f"{'causal' if c[4] else 'full'}"
                              for c in EDGE_CASES])
def test_bf16_bwd_kernels_tile_edges_on_card(cuda, bh, sq, sk, d, causal):
    """K3's and K4's bf16 kernels against ``flash_attention_bwd_plain`` at
    the tile edges, within the bf16 gradient tolerance; each run twice,
    bitwise equal.  At S = 1 the softmax has one key, so dq and dk vanish
    but for an lse cotangent: those cases carry one, as in chip_smoke.py."""
    gen = torch.Generator(device=cuda).manual_seed(sq * 5 + sk + d)
    q, do = (torch.randn((bh, sq, d), generator=gen, device=cuda).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((bh, sk, d), generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    o, lse = tattn.flash_attention_fwd_plain(q, k, v, causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    if sq == 1:
        delta = delta - torch.randn((bh, sq), generator=gen, device=cuda)
    kw = dict(causal=causal)
    dq, dq2 = (tattn.flash_attention_bwd_dq(q, k, v, lse, do, delta, **kw)
               for _ in range(2))
    (dk, dv), (dk2, dv2) = (tattn.flash_attention_bwd_dkv(
        q, k, v, lse, do, delta, **kw) for _ in range(2))
    want = tattn.flash_attention_bwd_plain(q, k, v, lse, do, delta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
        and torch.equal(dv, dv2)
    _hold_bf16_grads([g.float().cpu().numpy() for g in (dq, dk, dv)],
                     [w.float().cpu().numpy() for w in want])
