"""The port's int8 matmul (distributed_pytorch_tpu_torch/ops/quantized.py)
against the JAX package's (ops/quantized.py), on the CPU.

Quantization and the integer product are exact given the same float32
inputs, so the port is held BITWISE to the JAX functions: the quantized
values and scales, ``int8_matmul_xla`` and the Pallas kernel in interpret
mode (as tests/test_lowbit.py runs it), in float32 and cast to bfloat16 as
the JAX ``quantized_matmul`` casts it (the value of K5's bf16 epilogue).
The straight-through backward is held bitwise to its definition.  K5's
launch plan (csrc/int8_matmul.cu's plain C++, built alone by the host
compiler) is checked for its route rule, its shared memory and its
persistent walk over the output tiles; one tile's k loop and the
epilogue's staging for the TMA stores are replayed in numpy.  The
``cuda``-marked tests at the end hold the CUDA kernel K5 bitwise to the
plain version on the card, through both routes and both output dtypes,
and skip without a GPU.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.ops import quantized as jqz
from distributed_pytorch_tpu_torch.ops import _build
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


@pytest.mark.parametrize("out", sorted(DTYPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_plain_matches_jax_bitwise(m, k, n, dtype, out):
    """``int8_matmul_plain`` equals ``int8_matmul_xla`` and the Pallas
    kernel in interpret mode bit for bit, in float32 and cast to bf16 (the
    value K5's bf16 epilogue writes); the CPU wrapper is the plain
    version."""
    jx, jw, tx, tw = _operands(m, k, n, dtype, seed=7 * m + n)
    jout, tout = DTYPES[out][1:]
    got = tqz.int8_matmul_plain(tx, tw, tout)
    assert got.dtype == tout and got.shape == (m, n)
    _eq(got, jqz.int8_matmul_xla(jx, jw).astype(jout).astype(jnp.float32))
    _eq(got, jqz.int8_matmul(jx, jw, interpret=True).astype(jout)
        .astype(jnp.float32))
    assert torch.equal(tqz.int8_matmul(tx, tw, out_dtype=tout), got)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quantized_matmul_forward_matches_jax_bitwise(m, k, n, dtype):
    """The autograd entry point's forward in x's dtype is the JAX
    ``quantized_matmul`` forward (``int8_matmul_xla`` off the TPU, cast to
    x's dtype) bit for bit: in bf16 the cast K5 folds into its epilogue."""
    jx, jw, tx, tw = _operands(m, k, n, dtype, seed=3 * m + k)
    got = tqz.quantized_matmul(tx, tw)
    assert got.dtype == DTYPES[dtype][2]
    _eq(got, jqz.quantized_matmul(jx, jw).astype(jnp.float32))


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
    ok = (ones(4, 8, dtype=i8), ones(3, 8, dtype=i8), ones(4), ones(3))
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            tqz.int8_matmul_q(*args)
    with pytest.raises(ValueError, match="out_dtype"):
        tqz.int8_matmul_q(*ok, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="route"):
        tqz.int8_matmul_q(*ok, route="tma")
    with pytest.raises(ValueError, match="operands"):
        tqz.int8_matmul(ones(4, 8), ones(9, 3))


# -- K5's launch plan, built by the host compiler --------------------------

PLAN_FIELDS = ("route", "bm", "bn", "bk", "tiles_m", "tiles_n", "tiles",
               "blocks", "stages", "smem")
SMEM_LIMIT = 232448  # dynamic shared memory a block can use on the card
LM_SHAPES = [(8192, 1024, 1024), (8192, 1024, 4096), (8192, 4096, 1024)]


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """csrc/int8_matmul.cu's launch plan and tile walk, the part of the
    file that is plain C++, built alone by the host compiler: what every
    launch computes, checked without nvcc or a card."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the launch plan")
    out = tmp_path_factory.mktemp("int8_plan") / "libint8_matmul_plan.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1", "-shared",
                    "-fPIC", str(_build.CSRC / "int8_matmul.cu"), "-o",
                    str(out)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.int8_matmul_plan.argtypes = [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int64)]
    lib.int8_matmul_tile.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)]
    return lib


def _plan(lib, m, n, k, *, out_size=2, aligned=1, route=-1, n_sm=132):
    """The plan as a dict, or None where no launch takes the arguments."""
    out = (ctypes.c_int64 * len(PLAN_FIELDS))()
    if lib.int8_matmul_plan(m, n, k, out_size, aligned, route, n_sm, out):
        return None
    p = dict(zip(PLAN_FIELDS, out))
    p["route"] = tqz.ROUTES[p["route"]]
    return p


def _walk(lib, p) -> list:
    """Every (block, round, tile row, tile column) of the persistent walk."""
    got, tile = [], (ctypes.c_int * 2)()
    for block in range(p["blocks"]):
        r = 0
        while lib.int8_matmul_tile(block, p["blocks"], r, p["tiles"],
                                   p["tiles_n"], tile):
            got.append((block, r, tile[0], tile[1]))
            r += 1
    return got


@pytest.mark.parametrize("n_sm", [132, 7])
@pytest.mark.parametrize("m,k,n", LM_SHAPES + [
    (33, 77, 19), (33, 80, 20), (8191, 1024, 1024), (1024, 1024, 4100)])
def test_plan_walks_every_output_tile_once(plan_lib, m, k, n, n_sm):
    """The tiles cover (m, n) with none wholly past it; on the sm90 route
    one persistent block an SM (at most one a tile) walks them, each tile
    falling to exactly one block, the blocks' loads balanced to within
    one tile, the blocks running at once on neighbouring tiles, n
    fastest; the mma_sync route (k = 77) launches one block a tile.
    float32 output: n = 20 and 4100 are rows of whole 16-byte units."""
    p = _plan(plan_lib, m, n, k, out_size=4, n_sm=n_sm)
    assert p["route"] == ("sm90" if k % 16 == 0 else "mma_sync")
    bm, bn = p["bm"], p["bn"]
    assert (p["tiles_m"] - 1) * bm < m <= p["tiles_m"] * bm
    assert (p["tiles_n"] - 1) * bn < n <= p["tiles_n"] * bn
    assert p["tiles"] == p["tiles_m"] * p["tiles_n"]
    if p["route"] == "mma_sync":
        assert p["blocks"] == p["tiles"]
        return
    assert p["blocks"] == min(p["tiles"], n_sm)
    walk = _walk(plan_lib, p)
    tiles = sorted((tm, tn) for _, _, tm, tn in walk)
    assert tiles == [(tm, tn) for tm in range(p["tiles_m"])
                     for tn in range(p["tiles_n"])]
    per_block = np.bincount([b for b, _, _, _ in walk],
                            minlength=p["blocks"])
    assert per_block.min() >= 1 and per_block.max() - per_block.min() <= 1
    first = sorted((tm, tn) for b, r, tm, tn in walk if r == 0)
    assert first == [divmod(t, p["tiles_n"]) for t in range(p["blocks"])]


@pytest.mark.parametrize("k,n,out_size,aligned,route,want", [
    (1024, 1024, 2, 1, -1, "sm90"), (4096, 1024, 4, 1, -1, "sm90"),
    (1040, 1032, 2, 1, -1, "sm90"), (16, 8, 2, 1, -1, "sm90"),
    (1024, 4100, 4, 1, -1, "sm90"), (1024, 4100, 2, 1, -1, "mma_sync"),
    (1024, 1030, 4, 1, -1, "mma_sync"), (1000, 1024, 2, 1, -1, "mma_sync"),
    (77, 1024, 4, 1, -1, "mma_sync"), (1024, 1024, 2, 0, -1, "mma_sync"),
    (1024, 1024, 2, 1, 0, "mma_sync"), (1024, 1024, 4, 1, 1, "sm90"),
    (1000, 1024, 2, 1, 1, None), (1024, 1024, 2, 0, 1, None),
    (1024, 1030, 2, 1, 1, None)])
def test_plan_route_rule(plan_lib, k, n, out_size, aligned, route, want):
    """sm90 where TMA can read the int8 operands and write the output
    (k % 16 == 0, output rows of whole 16 bytes, every pointer 16-byte
    aligned), mma_sync elsewhere; the mma_sync route may be asked for
    anywhere, the sm90 route only where the rule allows it."""
    p = _plan(plan_lib, 8192, n, k, out_size=out_size, aligned=aligned,
              route=route)
    assert (p and p["route"]) == want


@pytest.mark.parametrize("out_size", [2, 4])
def test_plan_shared_memory_fits(plan_lib, out_size):
    """The sm90 tile (128 rows x 256 columns) with as many 128-byte k
    stages as fit beside the 32 KB of output staging, at least 4: the
    rings, staging and barriers stay within the 227 KB a block can use."""
    p = _plan(plan_lib, 8192, 4096, 1024, out_size=out_size)
    assert p["bn"] == 256 and p["bm"] == 128 and p["bk"] == 128
    ring = p["stages"] * (p["bm"] + p["bn"]) * p["bk"]
    staged = ring + 2 * 2 * 64 * 128
    assert p["stages"] >= 4 and staged < p["smem"] <= SMEM_LIMIT
    assert staged + (p["bm"] + p["bn"]) * p["bk"] > SMEM_LIMIT


@pytest.mark.parametrize("m,n,k,out_size,route", [
    (0, 8, 16, 2, -1), (8, 0, 16, 2, -1), (8, 8, 0, 2, -1),
    (8, 8, tqz.MAX_K + 16, 2, -1), (8, 8, 16, 8, -1), (8, 8, 16, 2, 2),
    (8, 8, 16, 2, -2), (65536 * 128 + 1, 8, 1000, 2, -1)])
def test_plan_refuses_what_no_launch_takes(plan_lib, m, n, k, out_size,
                                           route):
    """No plan for an empty side, k past the int32 bound, an output type
    other than float32 or bf16, an unknown route, or more mma_sync tile
    rows than grid.y holds."""
    assert _plan(plan_lib, m, n, k, out_size=out_size, route=route) is None


def _replay_tile(qx, qwt, tm, tn, p):
    """The sm90 route's k loop for output tile (tm, tn), in numpy: per k
    slice the two TMA boxes (bm rows of qx and bn rows of qwt, bk bytes,
    zeros past m, n and k), then its bk / 32 wgmma k32 steps summed into
    an int32 accumulator."""
    bm, bn, bk = p["bm"], p["bn"], p["bk"]
    k = qx.shape[1]
    acc = np.zeros((bm, bn), np.int32)
    for k0 in range(0, k, bk):
        a = np.zeros((bm, bk), np.int32)
        b = np.zeros((bn, bk), np.int32)
        blk = qx[tm * bm:(tm + 1) * bm, k0:k0 + bk]
        a[:blk.shape[0], :blk.shape[1]] = blk
        blk = qwt[tn * bn:(tn + 1) * bn, k0:k0 + bk]
        b[:blk.shape[0], :blk.shape[1]] = blk
        for s in range(0, bk, 32):
            acc += a[:, s:s + 32] @ b[:, s:s + 32].T
    return acc


@pytest.mark.parametrize("m,k,n", [(200, 1040, 304), (130, 272, 264),
                                   (128, 128, 256)])
def test_tile_k_loop_replay_is_exact_at_the_edges(plan_lib, m, k, n):
    """One tile's k loop over zero-filled 128-byte slices, replayed at the
    last tile row and column (the m, n and k edges), gives the exact int32
    sum, and the epilogue's acc * (sx * sw) on it is bitwise
    int8_matmul_plain in float32 and bf16."""
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x[0, :2] = (-9.0, 9.0)  # +-127 on row 0
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    qx, sx = tqz.quantize_rowwise(tx)
    qwt, sw = tqz.quantize_rowwise(tw.t())
    qx, qwt = qx.numpy().astype(np.int32), qwt.numpy().astype(np.int32)
    p = _plan(plan_lib, m, n, k)
    assert p["route"] == "sm90"
    tm, tn = p["tiles_m"] - 1, p["tiles_n"] - 1
    acc = _replay_tile(qx, qwt, tm, tn, p)
    r0, c0 = tm * p["bm"], tn * p["bn"]
    exact = qx[r0:] @ qwt[c0:].T
    rows, cols = exact.shape
    np.testing.assert_array_equal(acc[:rows, :cols], exact)
    assert not acc[rows:].any() and not acc[:, cols:].any()
    out = torch.from_numpy(acc[:rows, :cols]).float() * (
        sx[r0:] * sw.view(1, -1)[:, c0:])
    for odt in (torch.float32, torch.bfloat16):
        assert torch.equal(out.to(odt), tqz.int8_matmul_plain(
            tx, tw, odt)[r0:, c0:])


@pytest.mark.parametrize("out_size", [2, 4])
def test_epilogue_staging_replay(out_size):
    """The sm90 epilogue's shared-memory staging, replayed byte for byte:
    every lane of the four warps of a consumer warpgroup writes its
    accumulator pairs (row 16w + l/4 + 8h, columns 8j + 2(l%4), +1) into
    panels of 64 rows x 128 bytes, 16-byte chunk c of row r at c ^ (r % 8),
    a panel at a time; reading each panel back as TMA does (the swizzle
    undone, panel p at columns p x 128 / out_size) gives the warpgroup's
    64 x 256 tile exactly once, every byte of every panel written once."""
    bn, cols = 256, 128 // out_size        # tile width; columns a panel
    total, per_pass = bn // cols, 1
    tile = np.arange(64 * bn, dtype=np.int64).reshape(64, bn)
    got = np.full((64, bn), -1, np.int64)
    for ps in range(total // per_pass):
        panels = np.full((per_pass, 64, 128 // out_size), -1, np.int64)
        for warp in range(4):
            for lane in range(32):
                rl, cq, sz = 16 * warp + lane // 4, 2 * (lane % 4), lane // 4
                for j in range(ps * per_pass * cols // 8,
                               (ps + 1) * per_pass * cols // 8):
                    c = 8 * j + cq
                    byte = (c % cols) * out_size
                    panel = (c // cols) % per_pass
                    for h in range(2):
                        row = rl + 8 * h
                        a = (((byte // 16) ^ sz) * 16) + byte % 16
                        for e in range(2):  # the pair: two values
                            slot = a // out_size + e
                            assert panels[panel, row, slot] == -1
                            panels[panel, row, slot] = tile[row, c + e]
        assert (panels >= 0).all()
        for p in range(per_pass):  # what TMA reads: the swizzle undone
            for row in range(64):
                for chunk in range(8):
                    src = ((chunk ^ (row % 8)) * 16) // out_size
                    dst = (ps * per_pass + p) * cols + chunk * 16 // out_size
                    got[row, dst:dst + 16 // out_size] = panels[
                        p, row, src:src + 16 // out_size]
    np.testing.assert_array_equal(got, tile)


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K5 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "mma_sync"])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1024, 1024, 1024), (256, 4096, 1024),
                                   (33, 77, 19), (1000, 1000, 130),
                                   (129, 64, 4100), (200, 1040, 304)])
def test_kernel_matches_plain_on_card(cuda, dtype, out, route, m, k, n):
    """K5 is bitwise the plain version on the same inputs (tile-multiple,
    ragged, k that is not a multiple of 16, a k tail inside a 128-byte
    slice, a zero row, rows at +-127), in float32 and bf16 output, through
    the route the plan picks (sm90 where k % 16 == 0 and an output row is
    whole 16-byte units) and through the mma_sync route asked for; two
    runs are bitwise equal; one launch is counted per call, on the route
    it took."""
    rng = np.random.default_rng(m + n + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x[1] = 0.0
    x[2, :3] = (-5.0, 5.0, 2.5)
    x, w = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    qx, sx = tqz.quantize_rowwise(x)
    qwt, sw = tqz.quantize_rowwise(w.t())
    qwt = qwt.contiguous()
    took = route or ("sm90" if k % 16 == 0 and n * out.itemsize % 16 == 0
                     else "mma_sync")
    n0 = tqz.int8_matmul_q.launches
    r0 = tqz.int8_matmul_q.route_launches[took]
    got = tqz.int8_matmul_q(qx, qwt, sx, sw, out, route=route)
    again = tqz.int8_matmul_q(qx, qwt, sx, sw, out, route=route)
    want = tqz.int8_matmul_plain(x, w, out)
    torch.cuda.synchronize()
    assert tqz.int8_matmul_q.launches == n0 + 2
    assert tqz.int8_matmul_q.route_launches[took] == r0 + 2
    assert got.dtype == out and got.shape == (m, n)
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    assert not got[1].any()
    if route is None:
        assert torch.equal(tqz.int8_matmul(x, w, out_dtype=out), want)


@pytest.mark.cuda
def test_quantized_matmul_on_card(cuda):
    """The autograd entry point launches K5 (its sm90 route, bf16 out) in
    the forward and runs the plain straight-through products in the
    backward."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((300, 256)).astype(np.float32)
                         ).to(cuda, torch.bfloat16).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((256, 200)).astype(np.float32)
                         ).to(cuda, torch.bfloat16).requires_grad_(True)
    n0 = tqz.int8_matmul_q.launches
    s0 = tqz.int8_matmul_q.route_launches["sm90"]
    out = tqz.quantized_matmul(x, w)
    assert tqz.int8_matmul_q.launches == n0 + 1
    assert tqz.int8_matmul_q.route_launches["sm90"] == s0 + 1
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tqz.int8_matmul_plain(x.detach(), w.detach(),
                                                  torch.bfloat16))
    g = torch.ones_like(out)
    out.backward(g)
    assert torch.equal(x.grad, g @ w.detach().T)
    assert torch.equal(w.grad, x.detach().T @ g)
