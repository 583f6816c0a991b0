"""The port's int8 matmul (distributed_pytorch_tpu_torch/ops/quantized.py)
against the JAX package's (ops/quantized.py), on the CPU.

Quantization and the integer product are exact given the same float32
inputs, so the port is held BITWISE to the JAX functions: the quantized
values and scales, ``int8_matmul_xla`` and the Pallas kernel in interpret
mode (as tests/test_lowbit.py runs it).  The straight-through backward is
held bitwise to its definition.  The ``cuda``-marked tests at the end hold
the CUDA kernel K5 bitwise to the plain version on the card and skip
without a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.ops import quantized as jqz
from distributed_pytorch_tpu_torch.ops import quantized as tqz

# (m, k, n): the JAX tests' tiling shapes, one that tiles on the minimum
# int8 tile only, and one that cannot tile (the JAX wrapper's fallback)
SHAPES = [(128, 256, 128), (64, 128, 256), (96, 160, 224), (33, 77, 19)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers each running torch's
    default thread pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(m, k, n, dtype, seed):
    """x (m, k) and w (k, n) as JAX and torch arrays of ``dtype`` holding the
    same values (bf16 rounded once, on the JAX side, then carried)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x[1] = 0.0                                  # scale floor 1e-30
    x[2, :3] = (-5.0, 5.0, 2.5)                 # hits -127 / +127
    w[:, 0] *= 100.0                            # one wide column
    jx, jw = (jnp.asarray(a, DTYPES[dtype][1]) for a in (x, w))
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32)))
              .to(DTYPES[dtype][2]) for a in (jx, jw))
    return jx, jw, tx, tw


def _eq(got: torch.Tensor, want) -> None:
    got = got.float() if got.is_floating_point() else got
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quantize_matches_jax_bitwise(m, k, n, dtype):
    jx, jw, tx, tw = _operands(m, k, n, dtype, seed=m + k)
    for jfn, tfn, ja, ta in ((jqz.quantize_rowwise, tqz.quantize_rowwise,
                              jx, tx),
                             (jqz.quantize_colwise, tqz.quantize_colwise,
                              jw, tw)):
        jq, js = jfn(ja)
        tq, ts = tfn(ta)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert tuple(tq.shape) == jq.shape and tuple(ts.shape) == js.shape
        _eq(tq, jq)
        _eq(ts, js)
    q, s = tqz.quantize_rowwise(tx)
    assert int(q[2].abs().max()) == 127
    assert float(s[1, 0]) == np.float32(1e-30)
    assert not q[1].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_plain_matches_jax_bitwise(m, k, n, dtype):
    """``int8_matmul_plain`` equals ``int8_matmul_xla`` and the Pallas
    kernel in interpret mode bit for bit; the CPU wrapper is the plain
    version."""
    jx, jw, tx, tw = _operands(m, k, n, dtype, seed=7 * m + n)
    got = tqz.int8_matmul_plain(tx, tw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _eq(got, jqz.int8_matmul_xla(jx, jw))
    _eq(got, jqz.int8_matmul(jx, jw, interpret=True))
    assert torch.equal(tqz.int8_matmul(tx, tw), got)


def test_int8_matmul_is_exact_given_the_quantized_operands():
    """A numpy int32 product over the same (q, scale) pairs reproduces the
    output bitwise: quantization is the only approximation."""
    _, _, x, w = _operands(96, 160, 224, "float32", seed=1)
    qx, sx = tqz.quantize_rowwise(x)
    qw, sw = tqz.quantize_colwise(w)
    ref = (qx.numpy().astype(np.int32) @ qw.numpy().astype(np.int32)
           ).astype(np.float32) * (sx.numpy() * sw.numpy())
    _eq(tqz.int8_matmul_plain(x, w), ref)


def test_kernel_layout_quantizes_like_colwise():
    """The CUDA wrapper quantizes the weight as ``quantize_rowwise(w.T)``,
    the (n, k) layout K5 reads: the same int8 values and scales as
    ``quantize_colwise(w)``, bit for bit."""
    for dtype in DTYPES:
        _, _, _, w = _operands(8, 77, 19, dtype, seed=3)
        q, s = tqz.quantize_colwise(w)
        qt, st = tqz.quantize_rowwise(w.t())
        assert torch.equal(qt.contiguous(), q.t().contiguous())
        assert torch.equal(st.view(1, -1), s)


def test_quantized_matmul_backward_is_straight_through():
    """The backward differentiates the plain product: ``g @ w.T`` and
    ``x.T @ g`` exactly, though the forward ran int8; the forward is the
    int8 product cast to x's dtype."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = tqz.quantized_matmul(xr, wr)
    assert torch.equal(out.detach(), tqz.int8_matmul_plain(x, w))
    out.sin().sum().backward()
    g = out.detach().cos()
    assert torch.equal(xr.grad, g @ w.T)
    assert torch.equal(wr.grad, x.T @ g)
    # bf16 operands: the forward in bf16, the gradients in the input dtypes
    xb, wb = (t.to(torch.bfloat16).requires_grad_(True) for t in (x, w))
    outb = tqz.quantized_matmul(xb, wb)
    assert outb.dtype == torch.bfloat16
    assert torch.equal(outb.detach(), tqz.int8_matmul_plain(
        x.to(torch.bfloat16), w.to(torch.bfloat16)).to(torch.bfloat16))
    gb = torch.ones_like(outb)
    outb.backward(gb)
    assert torch.equal(xb.grad, gb @ wb.detach().T)
    assert torch.equal(wb.grad, xb.detach().T @ gb)


def test_quantized_matmul_grads_match_jax():
    """The port's straight-through gradients against the JAX custom VJP on
    the same inputs (float32 products in two BLAS orders: 1e-5)."""
    import jax
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 40)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jnp.sin(
        jqz.quantized_matmul(a, b))), argnums=(0, 1))(jnp.asarray(x),
                                                       jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    tqz.quantized_matmul(tx, tw).sin().sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-5)


def test_kernel_wrapper_refuses_what_k5_does_not_take():
    """K5's wrapper checks shapes, the int32 bound on k, dtypes and
    contiguity before it looks for the card, and never runs on the CPU."""
    i8 = torch.int8
    ones = torch.ones
    cases = [
        ((ones(4, 8, dtype=i8), ones(3, 9, dtype=i8), ones(4), ones(3)),
         "operands"),
        ((ones(1, tqz.MAX_K + 1, dtype=i8), ones(1, tqz.MAX_K + 1, dtype=i8),
          ones(1), ones(1)), "int32"),
        ((ones(4, 8), ones(3, 8, dtype=i8), ones(4), ones(3)), "qx"),
        ((ones(4, 8, dtype=i8), ones(3, 8, dtype=i8), ones(4),
          ones(3, dtype=torch.float64)), "sw"),
        ((ones(4, 8, dtype=i8), ones(8, 3, dtype=i8).t(), ones(4), ones(3)),
         "contiguous"),
        ((ones(4, 8, dtype=i8), ones(3, 8, dtype=i8), ones(4), ones(3)),
         "device")]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            tqz.int8_matmul_q(*args)
    with pytest.raises(ValueError, match="operands"):
        tqz.int8_matmul(ones(4, 8), ones(9, 3))


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K5 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1024, 1024, 1024), (256, 4096, 1024),
                                   (33, 77, 19), (1000, 1000, 130),
                                   (129, 64, 4100)])
def test_kernel_matches_plain_on_card(cuda, dtype, m, k, n):
    """K5 is bitwise the plain version on the same inputs (tile-multiple,
    ragged, k that is not a multiple of 16, a zero row, rows at +-127), and
    two runs are bitwise equal; one launch is counted per call."""
    rng = np.random.default_rng(m + n + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x[1] = 0.0
    x[2, :3] = (-5.0, 5.0, 2.5)
    x, w = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    n0 = tqz.int8_matmul_q.launches
    got = tqz.int8_matmul(x, w)
    again = tqz.int8_matmul(x, w)
    want = tqz.int8_matmul_plain(x, w)
    torch.cuda.synchronize()
    assert tqz.int8_matmul_q.launches == n0 + 2
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    assert not got[1].any()


@pytest.mark.cuda
def test_quantized_matmul_on_card(cuda):
    """The autograd entry point launches K5 in the forward and runs the
    plain straight-through products in the backward."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((300, 256)).astype(np.float32)
                         ).to(cuda, torch.bfloat16).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((256, 200)).astype(np.float32)
                         ).to(cuda, torch.bfloat16).requires_grad_(True)
    n0 = tqz.int8_matmul_q.launches
    out = tqz.quantized_matmul(x, w)
    assert tqz.int8_matmul_q.launches == n0 + 1
    assert torch.equal(out, tqz.int8_matmul_plain(x.detach(), w.detach())
                       .to(torch.bfloat16))
    g = torch.ones_like(out)
    out.backward(g)
    assert torch.equal(x.grad, g @ w.detach().T)
    assert torch.equal(w.grad, x.detach().T @ g)
