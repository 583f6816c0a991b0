"""The port's fused BN+ReLU backward (distributed_pytorch_tpu_torch
ops/fused_bn.py, ops/nn.py batchnorm_relu) against the JAX package's
(ops/fused_bn.py), on the CPU.

The JAX fused VJP runs its Pallas kernels in interpret mode on the CPU, as
tests/test_fused_bn.py runs them.  Shapes are that file's, NHWC there and
NCHW (channels_last) here; the tolerance is its own, rtol 2e-5 / atol 1e-5
(float32 reassociation between the closed form and autodiff).  The
``cuda``-marked tests at the end hold the CUDA kernels K1a / K1b against
the plain version on the card and skip without a GPU.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.ops import fused_bn as jfused
from distributed_pytorch_tpu.ops import nn as jnn
from distributed_pytorch_tpu_torch.ops import _build
from distributed_pytorch_tpu_torch.ops import fused_bn as tfused
from distributed_pytorch_tpu_torch.ops import nn as tnn

TOL = dict(rtol=2e-5, atol=1e-5)
SHAPES = [(8, 4, 4, 128), (16, 2, 2, 256), (8, 8, 8, 64), (4, 4, 4, 32)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU shapes: parallel test workers
    each running torch's default thread pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(shape, seed):
    """tests/test_fused_bn.py's inputs, as numpy (NHWC)."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    scale = rng.normal(1, 0.2, c).astype(np.float32)
    bias = rng.normal(0, 0.2, c).astype(np.float32)
    dr = rng.normal(size=shape).astype(np.float32)
    return x, scale, bias, dr


def _nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW channels_last tensor (the same memory order)."""
    return torch.from_numpy(a.copy()).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _rows(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> its (M, C) rows."""
    return torch.from_numpy(a.reshape(-1, a.shape[-1]).copy())


def _stats(x):
    x2 = x.reshape(-1, x.shape[-1])
    mean = x2.mean(0)
    var = (x2 ** 2).mean(0) - mean ** 2
    return mean, (1 / np.sqrt(var + 1e-5)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_closed_form(shape):
    """``bn_relu_bwd_plain`` is the JAX ``_bwd_xla``."""
    x, scale, bias, dr = _problem(shape, 0)
    mean, rstd = _stats(x)
    want = jfused._bwd_xla(*(jnp.asarray(v) for v in
                             (dr, x, mean, rstd, scale, bias)))
    got = tfused.bn_relu_bwd_plain(
        _nchw(dr), _nchw(x), *(torch.from_numpy(v) for v in
                               (mean, rstd, scale, bias)))
    np.testing.assert_allclose(_nhwc(got[0]), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _port_grads(x, scale, bias, dr, fused):
    xt = _nchw(x).requires_grad_(True)
    p = {"scale": torch.from_numpy(scale).requires_grad_(True),
         "bias": torch.from_numpy(bias).requires_grad_(True)}
    st = {"mean": torch.zeros(len(scale)), "var": torch.ones(len(scale))}
    r, new = tnn.batchnorm_relu(p, st, xt, train=True, fused=fused)
    g = torch.autograd.grad(r, (xt, p["scale"], p["bias"]), _nchw(dr))
    return r, new, g


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_autograd_matches_plain_and_jax(shape):
    """The fused forward is bitwise the plain one; the fused gradients equal
    the port's plain autograd, JAX's fused VJP (Pallas, interpret mode) and
    ``jax.grad`` of the plain composite."""
    x, scale, bias, dr = _problem(shape, 0)
    rp, _, gp = _port_grads(x, scale, bias, dr, fused=False)
    rf, _, gf = _port_grads(x, scale, bias, dr, fused=True)
    assert torch.equal(rp, rf)
    assert rf.is_contiguous(memory_format=torch.channels_last)
    c = shape[-1]
    jst = {"mean": jnp.zeros(c), "var": jnp.ones(c)}
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    jdr = jnp.asarray(dr)

    def jloss(fused):
        def f(p, xx):
            r, _ = jnn.batchnorm_relu(p, jst, xx, train=True, fused=fused)
            return jnp.sum(r * jdr)
        return jax.jit(jax.grad(f, argnums=(0, 1)))(jp, jnp.asarray(x))

    np.testing.assert_allclose(_nhwc(rf), np.maximum(np.asarray(
        jnn.batchnorm(jp, jst, jnp.asarray(x), train=True)[0]), 0), **TOL)
    for want in (jloss(True), jloss(False)):
        np.testing.assert_allclose(_nhwc(gf[0]), np.asarray(want[1]), **TOL)
        np.testing.assert_allclose(gf[1].numpy(), want[0]["scale"], **TOL)
        np.testing.assert_allclose(gf[2].numpy(), want[0]["bias"], **TOL)
    for a, b in zip(gf, gp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_running_stats_match_plain_and_jax():
    x, scale, bias, _ = _problem((8, 4, 4, 128), 1)
    st = {"mean": torch.zeros(128), "var": torch.ones(128)}
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    _, plain = tnn.batchnorm(p, st, _nchw(x), train=True)
    _, fused = tnn.batchnorm_relu(p, st, _nchw(x), train=True, fused=True)
    _, want = jnn.batchnorm({k: jnp.asarray(v.numpy()) for k, v in
                             p.items()}, {"mean": jnp.zeros(128),
                                          "var": jnp.ones(128)},
                            jnp.asarray(x), train=True)
    for k in ("mean", "var"):
        assert torch.equal(plain[k], fused[k])
        assert not fused[k].requires_grad
        np.testing.assert_allclose(fused[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("shape", [(8, 4, 4, 128), (8, 4, 4, 96),
                                   (2, 2, 2, 64), (4, 4, 4, 64),
                                   (3, 2, 2, 32), (16, 1, 1, 256)])
@pytest.mark.parametrize("train,axis", [(True, None), (False, None),
                                        (True, "data")])
def test_envelope_matches_jax(shape, train, axis):
    jx = jnp.zeros(shape)
    tx = _nchw(np.zeros(shape, np.float32))
    assert tfused.applicable(tx, train, axis) == \
        jfused.applicable(jx, train, axis)
    assert not tfused.supported(tx, train, axis)


def test_fused_refusals_and_eval_fall_through():
    """Explicit fused=True outside the envelope raises the JAX package's
    ValueError; eval with fused=True takes the plain path."""
    p = {"scale": torch.ones(128), "bias": torch.zeros(128)}
    st = {"mean": torch.zeros(128), "var": torch.ones(128)}
    x = torch.zeros((8, 128, 4, 4)).contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="does not cover"):
        tnn.batchnorm_relu(p, st, x, train=True, axis_name="data",
                           fused=True)
    p96 = {"scale": torch.ones(96), "bias": torch.zeros(96)}
    st96 = {"mean": torch.zeros(96), "var": torch.ones(96)}
    with pytest.raises(ValueError, match="does not cover"):
        tnn.batchnorm_relu(p96, st96, torch.zeros((8, 96, 4, 4)),
                           train=True, fused=True)
    y, _ = tnn.batchnorm_relu(p, st, x + 1, train=False, fused=True)
    y_plain, _ = tnn.batchnorm(p, st, x + 1, train=False)
    assert torch.equal(y, tnn.relu(y_plain))
    with pytest.raises(NotImplementedError, match="slice 5"):
        tnn.batchnorm(p, st, x, train=True, axis_name="data")


def test_bf16_forward_bitwise_and_backward_near_jax():
    """In bfloat16 the fused forward is still bitwise the plain one, the
    recomputed mask is the forward's, and the plain backward agrees with
    the JAX ``_bwd_xla`` in bf16 within one bf16 ulp of |da| plus 1e-3 of
    max|da| (the two frameworks round the bf16 chain at the same places,
    but reduce in a different order)."""
    x, scale, bias, dr = _problem((8, 8, 8, 64), 4)
    xb = _nchw(x).to(torch.bfloat16)
    drb = _nchw(dr).to(torch.bfloat16)
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    st = {"mean": torch.zeros(64), "var": torch.ones(64)}
    rp, _ = tnn.batchnorm_relu(p, st, xb, train=True, fused=False)
    rf, _ = tnn.batchnorm_relu(p, st, xb, train=True, fused=True)
    assert rf.dtype == torch.bfloat16 and torch.equal(rp, rf)
    mean, var, _ = tnn._train_stats(st, xb, None)
    rstd = torch.rsqrt(var + tnn.BN_EPS)
    dy, _ = tfused._mask_dy_xhat(drb, xb, mean, rstd, p["scale"],
                                 p["bias"])
    assert torch.equal(dy != 0, (rf > 0) & (drb != 0))
    got = tfused.bn_relu_bwd_plain(drb, xb, mean, rstd, p["scale"],
                                   p["bias"])
    want = jfused._bwd_xla(
        jnp.asarray(_nhwc(drb)).astype(jnp.bfloat16),
        jnp.asarray(_nhwc(xb)).astype(jnp.bfloat16),
        *(jnp.asarray(v.numpy()) for v in (mean, rstd, p["scale"],
                                           p["bias"])))
    da, ref = _nhwc(got[0]), np.asarray(want[0]).astype(np.float32)
    tol = np.abs(ref) * 2.0 ** -8 + 1e-3 * np.abs(ref).max()
    assert (np.abs(da - ref) <= tol).all()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-3)


def test_cpu_wrappers_run_the_plain_version_and_count_nothing():
    """On CPU tensors the wrappers run the plain version: no launch is
    counted, and the (M, C) wrappers equal the 4-D call."""
    x, scale, bias, dr = _problem((4, 4, 4, 32), 3)
    mean, rstd = _stats(x)
    vecs = [torch.from_numpy(v) for v in (mean, rstd, scale, bias)]
    before = (tfused.bn_relu_bwd_reduce.launches,
              tfused.bn_relu_bwd_apply.launches)
    da, dg, db = tfused.bn_relu_bwd(_nchw(dr), _nchw(x), *vecs)
    want = tfused.bn_relu_bwd_plain(_nchw(dr), _nchw(x), *vecs)
    for g, w in zip((da, dg, db), want):
        assert torch.equal(g, w)
    s1, s2 = tfused.bn_relu_bwd_reduce(_rows(dr), _rows(x), *vecs)
    torch.testing.assert_close(s1, db, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s2, dg, rtol=1e-6, atol=1e-6)
    da2 = tfused.bn_relu_bwd_apply(_rows(dr), _rows(x), *vecs, db, dg)
    assert torch.equal(da2, _nchw(_nhwc(da)).permute(0, 2, 3, 1)
                       .reshape(-1, 32))
    assert (tfused.bn_relu_bwd_reduce.launches,
            tfused.bn_relu_bwd_apply.launches) == before
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfused.bn_relu_bwd(_nchw(dr).double(), _nchw(x).double(), *vecs)


def test_rows_are_views_and_other_layouts_are_counted_copies():
    t = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    cl = t.contiguous(memory_format=torch.channels_last)
    copies = tfused.bn_relu_bwd.copies
    rows = tfused._rows(cl)
    assert rows.shape == (40, 3) and rows.data_ptr() == cl.data_ptr()
    assert tfused.bn_relu_bwd.copies == copies
    assert torch.equal(tfused._rows(t), rows)  # NCHW-contiguous: copied
    assert tfused.bn_relu_bwd.copies == copies + 1


THREADS = 256  # threads a block of csrc/fused_bn.cu (kThreads)
BLOCKS_PER_SM = 2  # row blocks an SM in its one wave (kBlocksPerSm)
MAX_TILES = 65535  # the arrival counters at the workspace's head (kMaxTiles)


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """csrc/fused_bn.cu's launch plan, the part of the file that is plain
    C++, built alone by the host compiler: the plan every launch computes,
    checked without nvcc or a card."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the launch plan")
    out = tmp_path_factory.mktemp("fused_bn_plan") / "libfused_bn_plan.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1", "-shared",
                    "-fPIC", str(_build.CSRC / "fused_bn.cu"), "-o",
                    str(out)], check=True)
    return ctypes.CDLL(str(out))


@pytest.mark.parametrize("m,c,itemsize,vec", [
    (262144, 64, 4, 4), (1024, 512, 2, 8), (4096, 512, 4, 4), (1000, 8, 2, 8),
    (1001, 12, 4, 4), (77, 6, 2, 1), (262144, 64, 2, 8), (300007, 64, 2, 8),
    (16384, 256, 2, 8), (1, 512, 2, 8), (5, 4096, 4, 4), (333, 97, 4, 1)])
@pytest.mark.parametrize("n_sm", [132, 7])
def test_kernel_geometry(plan_lib, m, c, itemsize, vec, n_sm):
    """The launch plan: 16-byte channel vectors where C and every pointer
    allow; channel tiles of at most one 128-byte line that cover C; row
    blocks that cover every row once, none empty and none past M; at most
    ``BLOCKS_PER_SM`` blocks an SM over the tiles (so K1a merges a
    bounded number of partials a tile), fewer only where the rows run
    out; a workspace that holds the counters and every block's partial
    row."""
    assert tfused._vec(c, itemsize, (0, 256)) == vec
    for ptrs in ((0, 8), (8, 0), (0, 256, 4)):  # a misaligned pointer
        assert tfused._vec(c, itemsize, ptrs) == 1
    p = tfused._plan(plan_lib, m, c, vec, itemsize, n_sm)
    tile, tiles, blocks, rows = p["tile"], p["tiles"], p["blocks"], p["rows"]
    cv = c // vec
    assert tile * vec * itemsize <= 128
    assert tile == cv or tile * vec * itemsize == 128
    assert (tiles - 1) * tile < cv <= tiles * tile
    assert p["ty_n"] == THREADS // tile
    assert (blocks - 1) * rows < m <= blocks * rows
    cap = -(-BLOCKS_PER_SM * n_sm // tiles)
    assert 1 <= blocks <= cap
    assert blocks == cap or rows <= p["ty_n"]
    stride = p["stride"]
    assert stride % 4 == 0 and 2 * tile * vec <= stride < 2 * tile * vec + 4
    assert p["workspace_floats"] == MAX_TILES + 1 + tiles * blocks * stride


@pytest.mark.parametrize("m,c,vec,itemsize", [
    (0, 64, 8, 2), (64, 0, 8, 2), (64, 12, 8, 2), (64, 64, 2, 2),
    (64, 64, 4, 8), (2 ** 24, 128, 8, 2), (1, 32 * 65536, 1, 4)])
def test_kernel_plan_refuses_what_no_launch_takes(plan_lib, m, c, vec,
                                                  itemsize):
    """No plan (so no launch) for an empty side, a vector width C does not
    divide or that is neither 16 bytes nor one channel, an itemsize the
    kernels lack, M * C past 2^31, or more channel tiles than counters."""
    with pytest.raises(ValueError, match="no launch plan"):
        tfused._plan(plan_lib, m, c, vec, itemsize, 132)


def _walk(p, m, cv, x, y, t, last_first):
    """csrc/fused_bn.cu's walk, replayed for thread t of block (x, y): the
    (row, channel vector) pairs it loads, in batches of kRowsInFlight rows
    ty_n apart; K1a walks its rows first to last, K1b last batch first."""
    tile, ty_n, rows = p["tile"], p["ty_n"], p["rows"]
    tx, ty = t % tile, t // tile
    v = y * tile + tx
    r0, r1 = x * rows + ty, min(m, (x + 1) * rows)
    if not (ty < ty_n and v < cv and r0 < r1):  # `on`
        return []
    step = 4 * ty_n
    starts = list(range(r0, r1, step))
    if last_first:
        assert starts[-1] == r0 + (r1 - 1 - r0) // step * step  # `last`
        starts.reverse()
    return [(r, v) for s in starts for r in range(s, s + step, ty_n)
            if r < r1]


@pytest.mark.parametrize("m,c,itemsize", [(1000, 8, 2), (77, 6, 2),
                                          (4099, 512, 4), (300, 97, 4),
                                          (333, 32, 2)])
@pytest.mark.parametrize("kernel", ["K1a", "K1b"])
def test_kernel_row_walk_covers_each_element_once(plan_lib, m, c, itemsize,
                                                  kernel):
    """csrc/fused_bn.cu's walk over the plan, replayed for every thread of
    every block, K1a's first to last and K1b's last batch first: each
    thread loads only rows of its own row block, below M, and every (row,
    channel vector) is loaded exactly once.  (1000, 8) and (333, 32) give
    row blocks with fewer rows than threads down them."""
    vec = tfused._vec(c, itemsize, (0,))
    p = tfused._plan(plan_lib, m, c, vec, itemsize, 132)
    cv = c // vec
    seen = np.zeros((m, cv), np.int32)
    for x in range(p["blocks"]):
        lo, hi = x * p["rows"], min(m, (x + 1) * p["rows"])
        for y in range(p["tiles"]):
            for t in range(THREADS):
                for r, v in _walk(p, m, cv, x, y, t, kernel == "K1b"):
                    assert lo <= r < hi
                    seen[r, v] += 1
    assert (seen == 1).all()


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K1a/K1b have no CPU mode")
    return torch.device("cuda")


def _near_zero_case(m, c, dtype, seed, dev):
    """Rows whose forward y lands on 0 or within an ulp of it, beside
    random rows; |dr| in [0.5, 2] so a flipped mask shows in da."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, c)).astype(np.float32)
    mean = rng.normal(0, 0.1, c).astype(np.float32)
    rstd = rng.uniform(0.5, 2.0, c).astype(np.float32)
    gamma = rng.normal(1, 0.2, c).astype(np.float32)
    beta = rng.normal(0, 0.2, c).astype(np.float32)
    beta[: c // 4] = 0.0                         # y == 0 where a == mean
    a[::7] = mean                                 # exact zeros
    inv = (rstd * gamma).astype(np.float64)
    edge = (mean - beta / inv).astype(np.float32)  # y ~ 0 through beta
    a[3::7] = edge
    a[4::7] = np.nextafter(edge, np.float32(np.inf))
    a[5::7] = np.nextafter(edge, np.float32(-np.inf))
    dr = (rng.uniform(0.5, 2.0, (m, c)) * rng.choice([-1, 1], (m, c))
          ).astype(np.float32)
    dr, a, mean, rstd, gamma, beta = (torch.from_numpy(v).to(dev) for v in
                                      (dr, a, mean, rstd, gamma, beta))
    return dr.to(dtype), a.to(dtype), mean, rstd, gamma, beta


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", [(4096, 64), (1000, 8), (1003, 512),
                                 (333, 32),
                                 # VGG-11's BN layers at batch 16
                                 (16384, 64), (4096, 128), (1024, 256),
                                 (256, 512), (64, 512)])
def test_kernels_match_plain_on_card(cuda, dtype, m, c):
    """K1a/K1b against the plain version on the same inputs: s1, s2 within
    1e-5 of max|s|, da float32 within 1e-5 of max|da| and bf16 within one
    bf16 ulp (plus that float32 bound), the masks identical (read back
    from da: dy = da / coef + (s1 + xhat s2) / M), and 50 launches more of
    each bitwise equal to the first (a stale arrival counter shows)."""
    dr, a, mean, rstd, gamma, beta = _near_zero_case(m, c, dtype, 5, cuda)
    s1, s2 = tfused.bn_relu_bwd_reduce(dr, a, mean, rstd, gamma, beta)
    da = tfused.bn_relu_bwd_apply(dr, a, mean, rstd, gamma, beta, s1, s2)
    ra, rg, rb = tfused.bn_relu_bwd_plain(dr, a, mean, rstd, gamma, beta)
    torch.cuda.synchronize()
    for got, ref in ((s1, rb), (s2, rg)):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    ref = ra.float()
    err = (da.float() - ref).abs()
    tol = 1e-5 * ref.abs().max()
    if dtype == torch.bfloat16:  # one bf16 ulp of the plain value
        _, e = torch.frexp(ref)
        tol = tol + torch.where(ref != 0, torch.ldexp(torch.ones_like(ref),
                                                      e - 8), 0.0)
    assert bool((err <= tol).all()), err.max().item()
    inv_c = (rstd * gamma).to(dtype)
    mask = tnn.normalize(a, mean, inv_c, beta) > 0
    xhat = (a.float() - mean) * rstd
    dy = da.float() / (gamma * rstd) + (s1 + xhat * s2) / m
    assert torch.equal(dy.abs() > 0.25, mask)
    for _ in range(50):
        s1b, s2b = tfused.bn_relu_bwd_reduce(dr, a, mean, rstd, gamma, beta)
        dab = tfused.bn_relu_bwd_apply(dr, a, mean, rstd, gamma, beta, s1b,
                                       s2b)
        assert torch.equal(s1, s1b) and torch.equal(s2, s2b)
        assert torch.equal(da, dab)


@pytest.mark.cuda
def test_fused_autograd_launches_kernels_on_card(cuda):
    x, scale, bias, dr = _problem((8, 8, 8, 64), 0)
    xt = _nchw(x).to(cuda).requires_grad_(True)
    p = {"scale": torch.from_numpy(scale).to(cuda).requires_grad_(True),
         "bias": torch.from_numpy(bias).to(cuda).requires_grad_(True)}
    st = {"mean": torch.zeros(64, device=cuda),
          "var": torch.ones(64, device=cuda)}
    before = (tfused.bn_relu_bwd_reduce.launches,
              tfused.bn_relu_bwd_apply.launches)
    r, _ = tnn.batchnorm_relu(p, st, xt, train=True, fused=True)
    g = torch.autograd.grad(r, (xt, p["scale"], p["bias"]),
                            _nchw(dr).to(cuda))
    assert (tfused.bn_relu_bwd_reduce.launches,
            tfused.bn_relu_bwd_apply.launches) == (before[0] + 1,
                                                   before[1] + 1)
    _, _, want = _port_grads(x, scale, bias, dr, fused=False)
    for a, b in zip(g, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), **TOL)
