"""The port's gradient-sync strategies (distributed_pytorch_tpu_torch/
parallel/strategies.py) against the JAX package's, on the CPU.

The same per-rank gradient arrays go through every JAX strategy under
``shard_map`` on the 4-device CPU mesh and through the port's strategy in
a 4-rank Gloo gang (tests/workers/torch_dp_worker.py, one process a rank,
rendezvous through a FileStore).  The leaves are given in the JAX tree
order and layout, as the port's trainer hands them over.  Held bitwise:
``gather_scatter`` (the rank-ordered sum), ``quantized`` (an integer sum
against a shared scale), ``quantized_ring`` at 8 and 4 bits and in
several buckets, ``quantized_ring_ef`` with its residual over two
rounds (the same hop order, round half to even on both sides), and
``hierarchical`` with ``dcn_compress`` int8 and int4 at dcn 2 x ici 2, its
residual over two rounds included (a sum of two addends over ``ici``,
then the ring over ``dcn``).  The float
sums (``all_reduce``, ``ddp``, ``bucketed``, ``gather_scatter_symmetric``,
``hierarchical`` at dcn 2 x ici 2) add in another order: rtol 1e-6.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from distributed_pytorch_tpu.parallel import strategies as jstrat
from distributed_pytorch_tpu.parallel.mesh import make_mesh
from distributed_pytorch_tpu.utils.compat import shard_map
from distributed_pytorch_tpu_torch.parallel import strategies as tstrat
from distributed_pytorch_tpu_torch.train import jax_order
from workers.torch_dp_worker import run_gang, shared_result

N_DEV = 4
BITWISE = ("gather_scatter", "quantized", "quantized_ring",
           "quantized_ring4", "quantized_ring_small", "quantized_ring_ef0",
           "quantized_ring_ef1", "none", "hierarchical_int80",
           "hierarchical_int81", "hierarchical_int40", "hierarchical_int41")
FLOAT_SUMS = ("all_reduce", "ddp", "bucketed", "bucketed_small",
              "gather_scatter_symmetric", "hierarchical")
FLOAT_TOL = dict(rtol=1e-6, atol=1e-7)

# VGG-11's 34 gradient leaves in JAX tree order (bnK.bias, bnK.scale, ...,
# convK.bias, convK.kernel, ..., fc.bias, fc.kernel): element counts
_WIDTHS = (64, 128, 256, 256, 512, 512, 512, 512)
VGG11_SIZES = ([c for c in _WIDTHS for _ in range(2)]
               + [n for i, c in enumerate(_WIDTHS) for n in (
                   c, 9 * c * ((3,) + _WIDTHS)[i])]
               + [10, 5120])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed: int) -> dict:
    """Per-rank gradients (leading axis: rank), keys in JAX tree order:
    a bias, a conv kernel in HWIO and a dense kernel, 3,265 values (a ring
    chunk of 4 blocks of 256 at n = 4, padded)."""
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal((N_DEV, 13)).astype(np.float32),
            "k": rng.standard_normal((N_DEV, 3, 3, 8, 16)).astype(np.float32),
            "w": rng.standard_normal((N_DEV, 300, 7)).astype(np.float32)}


def _jax_oracle() -> dict:
    g, h = _tree(0), _tree(1)
    flat, fac = make_mesh(N_DEV), Mesh(
        np.array(jax.devices()[:N_DEV]).reshape(2, 2), ("dcn", "ici"))

    def run(fn, mesh, axes, *trees):
        def body(*ts):
            local = [jax.tree.map(lambda x: x[0], t) for t in ts]
            return jax.tree.map(lambda x: x[None], fn(*local))
        spec = P(axes)
        return jax.jit(shard_map(body, mesh=mesh,
                                 in_specs=(spec,) * len(trees),
                                 out_specs=spec, check_vma=False))(*trees)

    cases = {name: (jstrat.get(name), flat, "data") for name in (
        "none", "all_reduce", "gather_scatter", "gather_scatter_symmetric",
        "ddp", "bucketed", "quantized", "quantized_ring")}
    cases["bucketed_small"] = (jstrat.Bucketed(bucket_mb=0.002), flat, "data")
    cases["quantized_ring4"] = (jstrat.QuantizedRing(bits=4), flat, "data")
    cases["quantized_ring_small"] = (jstrat.QuantizedRing(bucket_mb=0.002),
                                     flat, "data")
    cases["hierarchical"] = (jstrat.get("hierarchical"), fac, ("dcn", "ici"))
    out = {}
    for name, (s, mesh, axis) in cases.items():
        got = run(partial(s, axis=axis), mesh, axis, g)
        for i, leaf in enumerate(jax.tree.leaves(got)):
            out[f"{name}/{i}"] = np.asarray(leaf)
    stateful = {"quantized_ring_ef": (jstrat.get("quantized_ring_ef"), flat,
                                      "data")}
    for bits in ("int8", "int4"):
        stateful[f"hierarchical_{bits}"] = (
            jstrat.Hierarchical(dcn_compress=bits, dcn_size=2), fac,
            ("dcn", "ici"))
    for name, (s, mesh, axis) in stateful.items():
        res = np.zeros((N_DEV,) + s.init_state(
            jax.tree.map(lambda x: x[0], g), N_DEV).shape, np.float32)
        for r, tree in enumerate((g, h)):
            synced, res = run(lambda t, st, s=s, axis=axis: s(t, axis, st),
                              mesh, axis, tree, jnp.asarray(res))
            for i, leaf in enumerate(jax.tree.leaves(synced)):
                out[f"{name}{r}/{i}"] = np.asarray(leaf)
            out[f"{name}{r}/res"] = res = np.asarray(res)
    return out


def _port_gang(tmp_path_factory) -> dict:
    inputs = {}
    for prefix, seed in (("g", 0), ("h", 1)):
        for i, (_, a) in enumerate(sorted(_tree(seed).items())):
            inputs[f"{prefix}{i}"] = a
    ranks = run_gang("strategies", inputs,
                     str(tmp_path_factory.mktemp("strategies_gang")))
    return {f"rank{r}:{k}": v for r, out in enumerate(ranks)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    jax_out = shared_result(tmp_path_factory, "torch_strategies_jax",
                            _jax_oracle)
    port = shared_result(tmp_path_factory, "torch_strategies_port",
                         lambda: _port_gang(tmp_path_factory))
    return jax_out, port


def _pairs(results, name: str):
    jax_out, port = results
    keys = sorted(k for k in jax_out if k.startswith(name + "/"))
    assert keys
    for k in keys:
        for r in range(N_DEV):
            yield k, r, port[f"rank{r}:{k}"], jax_out[k][r]


@pytest.mark.parametrize("name", BITWISE)
def test_strategy_bitwise_equals_jax(results, name):
    for k, r, got, want in _pairs(results, name):
        assert got.shape == want.shape, (k, got.shape, want.shape)
        assert np.array_equal(got, want), \
            (k, r, float(np.abs(got - want).max()))


@pytest.mark.parametrize("name", FLOAT_SUMS)
def test_float_sum_strategy_equals_jax(results, name):
    for k, r, got, want in _pairs(results, name):
        np.testing.assert_allclose(got, want, err_msg=f"{k} rank {r}",
                                   **FLOAT_TOL)
    # and every rank holds the same result
    _, port = results
    for k in (k for k in results[0] if k.startswith(name + "/")):
        for r in range(1, N_DEV):
            assert np.array_equal(port[f"rank{r}:{k}"], port[f"rank0:{k}"])


def test_ef_residual_keeps_what_the_wire_dropped(results):
    """n * mean + the ranks' residuals == the exact sum (the EF
    invariant), on the port's outputs alone."""
    _, port = results
    g = _tree(0)
    exact = np.concatenate([g[k].sum(0).ravel() for k in sorted(g)])
    got = N_DEV * np.concatenate(
        [port[f"rank0:quantized_ring_ef0/{i}"].ravel() for i in range(3)])
    res = sum(port[f"rank{r}:quantized_ring_ef0/res"] for r in range(N_DEV))
    np.testing.assert_allclose(got + res[:exact.size], exact, atol=1e-5)
    assert np.abs(res).max() > 0


@pytest.mark.parametrize("bucket_mb", [25, 0.002, 1e-4])
def test_bucket_plan_equals_jax(bucket_mb):
    """make_bucket_plan on VGG-11's 34 leaf sizes (its 36.9 MB of float32
    gradients take two 25 MB buckets) and on tiny caps, from tensors and
    from SizedLeaf stand-ins."""
    cap = int(bucket_mb * 1024 * 1024)
    want = jstrat.make_bucket_plan(
        [jstrat.SizedLeaf(n, np.float32) for n in VGG11_SIZES], cap)
    got = tstrat.make_bucket_plan(
        [tstrat.SizedLeaf(n, np.float32) for n in VGG11_SIZES], cap)
    assert got == want
    assert tstrat.make_bucket_plan(
        [torch.zeros(n) for n in VGG11_SIZES], cap) == want
    if bucket_mb == 25:
        assert len(want) == 2


def test_many_bucket_tree_plan_and_ef_segments_equal_jax():
    leaves = [np.ones((300_000,), np.float32), np.ones((400_000,), np.float32),
              np.ones((8, 4), np.float32)]
    for cap in (1024 * 1024, 2 * 1024, 10 ** 9):
        assert tstrat.make_bucket_plan([torch.from_numpy(a) for a in leaves],
                                       cap) == \
            jstrat.make_bucket_plan([jnp.asarray(a) for a in leaves], cap)
    for mb in (25, 0.002):
        j = jstrat.QuantizedRingEF(bucket_mb=mb)
        t = tstrat.QuantizedRingEF(bucket_mb=mb)
        jl = [jnp.ones((300, 7)), jnp.ones((13,))]
        tl = [torch.ones(300, 7), torch.ones(13)]
        assert t.state_segments(tl, 4) == j.state_segments(jl, 4)
        assert t.init_state(tl, 4).shape == j.init_state(
            {"w": jl[0], "b": jl[1]}, 4).shape


def test_registry_equals_jax():
    """The registry, the overlap-capable strategies and the refusals (their
    messages JAX's); ``Hierarchical(dcn_compress=...)`` builds, stateful
    with JAX's residual segments (its numerics against JAX's are in
    test_strategy_bitwise_equals_jax)."""
    assert tstrat.available() == jstrat.available()
    assert len(tstrat.available()) == 10
    assert tstrat.overlap_capable() == jstrat.overlap_capable()
    with pytest.raises(ValueError, match="unknown strategy"):
        tstrat.get("nope")
    with pytest.raises(ValueError, match="must be resolved"):
        tstrat.get("auto")
    for bits in ("int8", "int4"):
        h = tstrat.Hierarchical(dcn_compress=bits, dcn_size=2)
        jh = jstrat.Hierarchical(dcn_compress=bits, dcn_size=2)
        assert h.stateful and jh.stateful
        leaves = [torch.zeros(n) for n in VGG11_SIZES]
        assert h.state_segments(leaves, 8) == jh.state_segments(
            [jnp.zeros(n) for n in VGG11_SIZES], 8)
    with pytest.raises(ValueError, match="dcn_compress must be") as te:
        tstrat.Hierarchical(dcn_compress="int2")
    with pytest.raises(ValueError) as je:
        jstrat.Hierarchical(dcn_compress="int2")
    assert str(te.value) == str(je.value)
    for name in ("all_reduce", "gather_scatter"):
        with pytest.raises(ValueError) as te:
            tstrat.require_overlap_capable(tstrat.get(name))
        with pytest.raises(ValueError) as je:
            jstrat.require_overlap_capable(jstrat.get(name))
        assert str(te.value) == str(je.value)
    for kw in (dict(fsdp=False, dcn=False), dict(fsdp=False, dcn=False,
                                                 pp=False)):
        with pytest.raises(ValueError) as te:
            tstrat.require_lm_overlap_streamable(**kw)
        with pytest.raises(ValueError) as je:
            jstrat.require_lm_overlap_streamable(**kw)
        assert str(te.value) == str(je.value)


def test_sync_boundaries_sync_the_summed_cotangent():
    """``sync_boundary`` is an identity in the forward whose backward hands
    ``sync_fn`` the cotangent autograd summed over every use (here two),
    and its result becomes the leaf's gradient; ``sync_boundary_stateful``
    also hands it the residual and delivers the new one."""
    w = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    b = torch.ones(3, requires_grad=True)
    seen = {}

    def sync_fn(cts):
        seen["cts"] = [c.clone() for c in cts]
        return [c * 10 for c in cts]

    mw, mb = tstrat.sync_boundary([w, b], sync_fn, group_id=0)
    assert torch.equal(mw, w) and torch.equal(mb, b)
    ((mw * 2).sum() + (mw * mb).sum() + mb.sum()).backward()
    want_w = 2 + b.detach().expand(2, 3)
    want_b = w.detach().sum(0) + 1
    assert torch.equal(seen["cts"][0], want_w)
    assert torch.equal(seen["cts"][1], want_b)
    assert torch.equal(w.grad, want_w * 10) and torch.equal(b.grad,
                                                            want_b * 10)
    out = {}
    w.grad = None
    res = torch.full((4,), 0.5)
    (mw,) = tstrat.sync_boundary_stateful(
        [w], res, lambda cts, r: ([c + r.sum() for c in cts], r * 2),
        out=out)
    mw.sum().backward()
    assert torch.equal(w.grad, torch.full((2, 3), 3.0))
    assert torch.equal(out["res"], res * 2)


def test_inflight_keeps_results_not_cotangents():
    """``_InFlight`` holds a launched bucket's targets and results until
    the backward ends, and none of its cotangents (under ZeRO-3 they are
    the gathered-size gradients, which must be freed a group at a time);
    the results reach ``.grad`` when the backward is done."""
    w = torch.ones(3, requires_grad=True)
    inflight = tstrat._InFlight()
    seen = {}

    def backward_fn(cts):
        inflight.launch(lambda cs: [c * 2 for c in cs], cts, [w])
        seen["held"] = {id(t) for entry in inflight.pending
                        for part in entry for t in part}
        seen["cts"] = {id(c) for c in cts}
        assert w.grad is None
        return [None]

    (m,) = tstrat.sync_boundary([w], backward_fn, group_id=0)
    (m * 3).sum().backward()
    assert seen["cts"] and not seen["held"] & seen["cts"]
    assert torch.equal(w.grad, torch.full((3,), 6.0))
    assert inflight.pending == [] and not inflight.queued


def test_int4_nibble_packing_round_trips():
    q = torch.arange(-7, 8, dtype=torch.int8).repeat(4)[:58].reshape(2, 29)
    q = torch.cat([q, q.flip(-1)], -1)
    packed = tstrat.QuantizedRing._pack(q)
    assert packed.dtype == torch.int8 and packed.numel() == q.numel() // 2
    assert torch.equal(tstrat.QuantizedRing._unpack(packed, q.shape), q)
    jpacked = jstrat.QuantizedRing(bits=4)._pack(jnp.asarray(q.numpy()))
    assert np.array_equal(np.asarray(jpacked), packed.numpy())


def test_jax_order_is_jax_tree_order():
    from distributed_pytorch_tpu.models import vgg as jvgg
    from distributed_pytorch_tpu_torch.models import vgg as tvgg
    jparams, _ = jvgg.init(jax.random.key(0), "VGG11")
    tparams, _ = tvgg.init(0, "VGG11", device="cpu")
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert jax_order(tparams) == paths
    assert [tparams[k][n].numel() for k, n in jax_order(tparams)] == \
        VGG11_SIZES
