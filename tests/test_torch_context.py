"""The port's ring attention (distributed_pytorch_tpu_torch/parallel/
context.py) against the JAX package's on the CPU.

- The zigzag helpers bitwise JAX's; ``_merge`` against JAX's within one
  float32 ulp-scale tolerance (each package's own exp/log).
- The ring through ``LoopbackRing`` (every rank's steps in one process,
  rank r's chunk at step t being rank (r - t) mod n's original) against
  one causal attention over the whole sequence, and against JAX
  ``ring_attention(impl="flash")`` under ``shard_map`` over n virtual
  devices: the output and the gradients of q, k and v for a fixed
  cotangent, n = 2 and 4, both layouts; f32, rtol 1e-5 / atol 2e-6 against
  JAX, atol 2e-6 against the whole-sequence attention.
- The ring over a real process group (``GroupRing``: P2P shifts forward,
  their cotangents shifted back) in the 2- and 4-rank Gloo gangs of
  tests/test_torch_tp.py (worker mode ``tp``, run once a session): each
  rank's chunk of the output and gradients against JAX's at the same
  tolerance, and its output bitwise the loopback's (the same operations on
  the same values; the gradients sum in another order).
- The chunk-pair attentions a ring runs (each one K2 launch on the card,
  and K3 + K4 in the backward) counted per rank: ``ring_launches`` — the
  zigzag ``2n - 1``, the contiguous ring ``1 + r`` on rank r, its fully
  masked steps skipped (ROADMAP queue 3: a divergence in launches, not in
  values).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from distributed_pytorch_tpu.parallel import context as jctx
from distributed_pytorch_tpu.utils.compat import shard_map
from distributed_pytorch_tpu_torch.ops import attention as tattn
from distributed_pytorch_tpu_torch.parallel import context as tctx
from test_torch_tp import gang, gang_inputs

RINGS = [(n, layout) for n in (2, 4) for layout in ("contiguous", "zigzag")]
IDS = [f"n{n}-{layout}" for n, layout in RINGS]
JAX_TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,s", [(1, 8), (2, 64), (4, 64), (8, 1024)])
def test_zigzag_helpers_bitwise_jax(n, s):
    np.testing.assert_array_equal(tctx.zigzag_permutation(n, s),
                                  jctx.zigzag_permutation(n, s))
    np.testing.assert_array_equal(tctx.inverse_zigzag_permutation(n, s),
                                  jctx.inverse_zigzag_permutation(n, s))
    s_local = s // n
    for me in range(n):
        np.testing.assert_array_equal(
            tctx.zigzag_positions(me, n, s_local).numpy(),
            np.asarray(jctx.zigzag_positions(me, n, s_local)))
    for mod in (tctx, jctx):
        with pytest.raises(ValueError, match="zigzag chunks"):
            mod.zigzag_permutation(n, s + 1)


def test_merge_matches_jax():
    """The online-softmax merge against JAX's on shared partials, a
    NEG_INF partial included (it vanishes exactly in both)."""
    rng = np.random.default_rng(3)
    o1, o2 = (rng.standard_normal((2, 2, 8, 4)).astype(np.float32)
              for _ in range(2))
    l1, l2 = (3 * rng.standard_normal((2, 2, 8)).astype(np.float32)
              for _ in range(2))
    l2[0, 0, :3] = tattn.NEG_INF
    jo, jl = jctx._merge(*(jnp.asarray(a) for a in (o1, l1, o2, l2)))
    to, tl = tctx._merge(*(torch.from_numpy(a) for a in (o1, l1, o2, l2)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-7,
                               atol=1e-7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-7)
    np.testing.assert_array_equal(to[0, 0, :3].numpy(), o1[0, 0, :3])
    np.testing.assert_array_equal(tl[0, 0, :3].numpy(), l1[0, 0, :3])


def _perm(n, layout, s):
    return (tctx.zigzag_permutation(n, s) if layout == "zigzag"
            else np.arange(s))


def _jax_ring(n, layout) -> dict:
    """JAX ``ring_attention`` (flash chunk pairs) under ``shard_map`` over
    n devices, on the permuted whole q/k/v: the output and the gradients
    of sum(o * g), in the permuted layout (one jitted program: eager
    ``shard_map`` dispatch costs ~8x the compile)."""
    data = gang_inputs()
    s = data["ring/q"].shape[2]
    perm = _perm(n, layout, s)
    q, k, v, g = (jnp.asarray(data[f"ring/{x}"][:, :, perm])
                  for x in ("q", "k", "v", "g"))
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    ring = shard_map(partial(jctx.ring_attention, axis="seq", causal=True,
                             impl="flash", layout=layout),
                     mesh=mesh, in_specs=(P(None, None, "seq"),) * 3,
                     out_specs=P(None, None, "seq"))

    @jax.jit
    def fwd_bwd(q, k, v, g):
        o, pull = jax.vjp(ring, q, k, v)
        return (o, *pull(g))

    return dict(zip(("o", "dq", "dk", "dv"),
                    map(np.asarray, fwd_bwd(q, k, v, g))))


@pytest.fixture(scope="module")
def jax_rings(tmp_path_factory):
    from workers.torch_dp_worker import shared_result
    return {(n, layout): shared_result(
        tmp_path_factory, f"torch_ctx_jax_{n}_{layout}",
        partial(_jax_ring, n, layout)) for n, layout in RINGS}


def _loopback(n, layout, impl="flash"):
    """Every rank's ring in one process over the permuted whole q/k/v:
    the output and the gradients of sum(o * g), permuted layout, and the
    chunk-pair attentions each rank ran."""
    data = gang_inputs()
    s = data["ring/q"].shape[2]
    perm = torch.as_tensor(_perm(n, layout, s))
    q, k, v = (torch.from_numpy(data[f"ring/{x}"])[:, :, perm]
               .clone().requires_grad_(True) for x in ("q", "k", "v"))
    g = torch.from_numpy(data["ring/g"])[:, :, perm]
    c = s // n
    qs, ks, vs = ([x[:, :, r * c:(r + 1) * c] for r in range(n)]
                  for x in (q, k, v))
    calls, real = [], tctx._attn
    outs = []
    try:
        for r in range(n):
            calls.append(0)

            def counting(*a, **kw):
                calls[-1] += 1
                return real(*a, **kw)

            tctx._attn = counting
            outs.append(tctx.ring_attention(
                qs[r], ks[r], vs[r], tctx.LoopbackRing(r, ks, vs),
                layout=layout, impl=impl))
    finally:
        tctx._attn = real
    o = torch.cat(outs, dim=2)
    (o * g).sum().backward()
    return {"o": o.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy(), "calls": calls}


@pytest.mark.parametrize("n,layout", RINGS, ids=IDS)
@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_loopback_ring_matches_whole_attention(n, layout, impl):
    """The loopback ring, un-permuted, equals one causal attention over
    the whole sequence, forward and backward."""
    data = gang_inputs()
    s = data["ring/q"].shape[2]
    inv = np.argsort(_perm(n, layout, s))
    got = _loopback(n, layout, impl)
    q, k, v = (torch.from_numpy(data[f"ring/{x}"]).requires_grad_(True)
               for x in ("q", "k", "v"))
    o = tattn.attention_reference(q, k, v, causal=True)
    (o * torch.from_numpy(data["ring/g"])).sum().backward()
    want = {"o": o.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}
    for x in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[x][:, :, inv], want[x], rtol=1e-5,
                                   atol=2e-6, err_msg=x)


@pytest.mark.parametrize("n,layout", RINGS, ids=IDS)
def test_loopback_ring_matches_jax(jax_rings, n, layout):
    got, want = _loopback(n, layout), jax_rings[(n, layout)]
    for x in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[x], want[x], err_msg=x, **JAX_TOL)


@pytest.mark.parametrize("n,layout", RINGS, ids=IDS)
def test_ring_launches_per_rank(n, layout):
    """Each rank's chunk-pair attentions are ``ring_launches``'s: the
    zigzag ring's 2n - 1 on every rank (the diagonal and two half pairs a
    step), the contiguous ring's 1 + r (its masked steps skipped)."""
    assert _loopback(n, layout)["calls"] == tctx.ring_launches(n, layout)
    assert tctx.ring_launches(n, "zigzag") == [2 * n - 1] * n
    assert tctx.ring_launches(n, "contiguous") == [1 + r for r in range(n)]
    assert tctx.ring_launches(n, "contiguous", causal=False) == [n] * n
    assert tctx.ring_launches(1, "zigzag") == [1]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return gang(tmp_path_factory)


GANG_RINGS = [(4, 2), (4, 4), (2, 2)]  # (gang world size, ring size)


@pytest.mark.parametrize("world,n", GANG_RINGS,
                         ids=[f"w{w}-n{n}" for w, n in GANG_RINGS])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_gang_ring_matches_jax(port, jax_rings, world, n, layout):
    """Each rank's chunk of the output and of dq, dk, dv over a real
    ring of n ranks (P2P shifts; at world 4 and n = 2, two rings side by
    side) against JAX's, and its output bitwise the loopback's."""
    want = jax_rings[(n, layout)]
    loop = _loopback(n, layout)
    c = want["o"].shape[2] // n
    for r in range(world):
        me = r % n
        part = slice(me * c, (me + 1) * c)
        for x in ("o", "dq", "dk", "dv"):
            got = port[f"w{world}r{r}:ring/{n}/{layout}/{x}"]
            np.testing.assert_allclose(got, want[x][:, :, part],
                                       err_msg=f"rank {r} {x}", **JAX_TOL)
            np.testing.assert_allclose(got, loop[x][:, :, part], rtol=1e-6,
                                       atol=1e-6, err_msg=f"rank {r} {x}")
        np.testing.assert_array_equal(
            port[f"w{world}r{r}:ring/{n}/{layout}/o"], loop["o"][:, :, part])


def test_ring_checks_its_arguments():
    q = torch.zeros((1, 1, 8, 4))
    ring = tctx.LoopbackRing(0, [q, q], [q, q])
    with pytest.raises(ValueError, match="impl must be"):
        tctx.ring_attention(q, q, q, ring, impl="pallas")
    with pytest.raises(ValueError, match="layout must be"):
        tctx.ring_attention(q, q, q, ring, layout="striped")
    odd = torch.zeros((1, 1, 7, 4))
    with pytest.raises(ValueError, match="even local sequence"):
        tctx.ring_attention(odd, odd, odd,
                            tctx.LoopbackRing(0, [odd, odd], [odd, odd]),
                            layout="zigzag", impl="reference")
