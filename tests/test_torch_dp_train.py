"""The port's data-parallel VGG trainer (distributed_pytorch_tpu_torch/
train.py over parallel/) against the JAX package's, on the CPU.

The port's ``Trainer`` runs in a 4-rank Gloo gang (tests/workers/
torch_dp_worker.py); the JAX ``Trainer(cfg, make_mesh(4))`` runs on the
4-device CPU mesh.  Both start from the JAX trainer's initial params
(convert.py) and take three float32 steps on the JAX strategy suite's data
(tests/test_strategies.py: 4 ranks x 4 TINY images from
``default_rng(7)``, no augmentation); rank r's shard is rows [4r, 4r + 4),
as the JAX mesh splits the global batch.

At lr 0.1 a BN output within ~1e-6 of 0 falls on the other side of the
ReLU in one package and the trajectories part (tests/test_torch_train.py's
docstring), so the runs take lr 0.02, where they stay within float32
noise.  Held: losses at rtol 1e-5; params and BN state at rtol 1e-5,
atol 1e-6, for ``ddp`` (rank 0's buffers), ``all_reduce`` with local BN
(each rank's state against JAX's stacked row), ``sync_bn`` and
``hierarchical`` (2 x 2).  The momentum buffers are sums of gradients,
whose float32 noise is relative to each tensor's largest entry: they are
held to 1e-4 of it plus 1e-5, as tests/test_torch_train.py holds one step.
``quantized_ring_ef`` is held to lr times the largest block quantum a
step, summed with the momentum's carry: an ulp of gradient difference
between XLA and torch can move a value one quantum.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import train as jtrain
from distributed_pytorch_tpu.parallel.mesh import make_mesh
from distributed_pytorch_tpu_torch import train as ttrain
from distributed_pytorch_tpu_torch.data import augment as taug
from distributed_pytorch_tpu_torch.models import vgg as tvgg
from workers.torch_dp_worker import run_gang, shared_result

N_DEV = 4
PER_DEV_BATCH = 4
STEPS = 3
LR = 0.02
TOL = dict(rtol=1e-5, atol=1e-6)
MOMENTUM_NOISE = 1e-4   # of a tensor's largest entry, plus 1e-5
BASE = dict(model="TINY", batch_size=PER_DEV_BATCH, augment=False, lr=LR)
CASES = {
    "ddp": dict(strategy="ddp"),
    "all_reduce_local_bn": dict(strategy="all_reduce",
                                broadcast_buffers=False),
    "sync_bn": dict(strategy="ddp", sync_bn=True),
    "quantized_ring_ef": dict(strategy="quantized_ring_ef"),
    "hierarchical": dict(strategy="hierarchical", dcn_size=2),
}
EXACT = ("ddp", "all_reduce_local_bn", "sync_bn", "hierarchical")
# port-only: two steps in one train_steps call against two single calls
PORT_ONLY = {"ddp_2_single": dict(cfg=dict(BASE, strategy="ddp"), steps=2),
             "ddp_2_in_one_call": dict(cfg=dict(BASE, strategy="ddp"),
                                       steps=2, steps_per_call=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.default_rng(7)
    n = N_DEV * PER_DEV_BATCH
    images = rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, n).astype(np.int32)
    return images, labels


def _flat(prefix: str, tree) -> dict:
    return {f"{prefix}/{k}/{n}": np.asarray(a) for k, v in tree.items()
            for n, a in v.items()}


def _jax_runs() -> dict:
    images, labels = _batch()
    out = {}
    for name, kw in CASES.items():
        cfg = jtrain.TrainConfig(**BASE, **kw)
        if kw["strategy"] == "hierarchical":
            tr = jtrain.Trainer(cfg, num_devices=N_DEV)
        else:
            tr = jtrain.Trainer(cfg, make_mesh(N_DEV))
        if name == "ddp":
            out.update(_flat("init/p", jax.tree.map(np.asarray, tr.params)))
            out.update(_flat("init/s", tr.eval_state()))
        out[f"{name}/losses"] = np.asarray(
            [float(tr.train_step(images, labels)) for _ in range(STEPS)])
        out.update(_flat(f"{name}/p", jax.tree.map(np.asarray, tr.params)))
        out.update(_flat(f"{name}/s", jax.tree.map(np.asarray, tr.state)))
        trace = [s for s in jax.tree.leaves(
            tr.opt_state, is_leaf=lambda x: hasattr(x, "trace"))
            if hasattr(s, "trace")][0].trace
        out.update(_flat(f"{name}/m", jax.tree.map(np.asarray, trace)))
        out[f"{name}/sync_state"] = np.asarray(tr.sync_state)
    return out


def _port_runs(tmp_path_factory, jax_out) -> dict:
    images, labels = _batch()
    inputs = {"images": images, "labels": labels}
    inputs.update({k[len("init/"):]: v for k, v in jax_out.items()
                   if k.startswith("init/")})
    cases = {name: dict(cfg=dict(BASE, **kw), steps=STEPS)
             for name, kw in CASES.items()}
    cases.update(PORT_ONLY)
    ranks = run_gang("train", inputs,
                     str(tmp_path_factory.mktemp("dp_train_gang")),
                     cases=cases)
    return {f"rank{r}:{k}": v for r, out in enumerate(ranks)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_out = shared_result(tmp_path_factory, "torch_dp_train_jax", _jax_runs)
    port = shared_result(tmp_path_factory, "torch_dp_train_port",
                         lambda: _port_runs(tmp_path_factory, jax_out))
    return jax_out, port


def _keys(jax_out, name, tag):
    return sorted(k for k in jax_out if k.startswith(f"{name}/{tag}/"))


@pytest.mark.parametrize("name", EXACT)
def test_losses_and_params_equal_jax(runs, name):
    jax_out, port = runs
    for r in range(N_DEV):
        np.testing.assert_allclose(port[f"rank{r}:{name}/losses"],
                                   jax_out[f"{name}/losses"], rtol=1e-5)
    for tag in ("p", "m"):
        for k in _keys(jax_out, name, tag):
            for r in range(N_DEV):
                # replicated: every rank bitwise rank 0's
                assert np.array_equal(port[f"rank{r}:{k}"],
                                      port[f"rank0:{k}"]), (k, r)
            if tag == "p":
                np.testing.assert_allclose(port[f"rank0:{k}"], jax_out[k],
                                           err_msg=k, **TOL)
            else:
                err = np.abs(port[f"rank0:{k}"] - jax_out[k]).max()
                assert err <= MOMENTUM_NOISE * np.abs(jax_out[k]).max() \
                    + 1e-5, (k, err)


@pytest.mark.parametrize("name", EXACT)
def test_bn_state_per_rank_equals_jax_rows(runs, name):
    """Each rank's BN running state against the JAX trainer's stacked row
    of that replica: rank 0's everywhere under ddp's broadcast buffers and
    under sync-BN, each replica's own under local BN (all_reduce with
    broadcast_buffers=False, and hierarchical, whose default it is)."""
    jax_out, port = runs
    keys = _keys(jax_out, name, "s")
    assert keys
    distinct = False
    for k in keys:
        for r in range(N_DEV):
            np.testing.assert_allclose(port[f"rank{r}:{k}"], jax_out[k][r],
                                       err_msg=f"{k} rank {r}", **TOL)
            distinct |= not np.array_equal(jax_out[k][r], jax_out[k][0])
    assert distinct == (name in ("all_reduce_local_bn", "hierarchical"))


def test_quantized_ring_ef_within_a_quantum_a_step(runs):
    """Params within lr x the largest block quantum of each step's synced
    gradient (its largest |value| / 127, the value read off the momentum
    buffer's growth), carried by the momentum into every later step (1 +
    mu + mu^2 ... of each step's error); the residual within a quantum of
    the ranks' summed gradient (n x that); the first loss at rtol 1e-5 and
    the later ones, which see params apart by up to the bound, at 1e-4
    (measured 2.4e-5)."""
    jax_out, port = runs
    name = "quantized_ring_ef"
    quanta = port[f"rank0:{name}/grad_max"] / 127.0
    bound = LR * sum(quanta[t] * sum(0.9 ** j for j in range(STEPS - t))
                     for t in range(STEPS))
    for r in range(N_DEV):
        got = port[f"rank{r}:{name}/losses"]
        want = jax_out[f"{name}/losses"]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-4)
    worst = 0.0
    for k in _keys(jax_out, name, "p"):
        worst = max(worst, float(np.abs(port[f"rank0:{k}"]
                                        - jax_out[k]).max()))
        for r in range(N_DEV):
            assert np.array_equal(port[f"rank{r}:{k}"], port[f"rank0:{k}"])
    assert 0 < worst <= bound, (worst, bound)
    for r in range(N_DEV):
        got = port[f"rank{r}:{name}/sync_state"]
        want = jax_out[f"{name}/sync_state"][r]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= N_DEV * quanta.max(), r


def test_steps_per_loop_two_equals_two_single_steps(runs):
    _, port = runs
    keys = sorted(k.split(":", 1)[1] for k in port
                  if k.startswith("rank0:ddp_2_single/")
                  and not k.endswith("/grad_max"))
    assert keys
    for r in range(N_DEV):
        for k in keys:
            other = k.replace("ddp_2_single", "ddp_2_in_one_call")
            assert np.array_equal(port[f"rank{r}:{k}"],
                                  port[f"rank{r}:{other}"]), (k, r)


# -- port-only: sync-BN against one process, the invariants ---------------

@pytest.fixture(scope="module")
def syncbn(runs, tmp_path_factory):
    jax_out, _ = runs
    images, labels = _batch()
    inputs = {"images": images, "labels": labels}
    inputs.update({k[len("init/"):]: v for k, v in jax_out.items()
                   if k.startswith("init/")})
    return shared_result(tmp_path_factory, "torch_dp_syncbn", lambda: {
        f"rank{r}:{k}": v for r, out in enumerate(run_gang(
            "syncbn", inputs, str(tmp_path_factory.mktemp("syncbn_gang"))))
        for k, v in out.items()}), inputs


def test_sync_bn_over_four_ranks_equals_one_process(syncbn):
    """Sync-BN over 4 ranks x 4 images (the moments' cross-rank mean and
    its backward, then ddp's mean of the gradients) equals one process on
    the 16-image batch: the loss (the mean of the ranks'), every gradient
    and the new BN state."""
    from distributed_pytorch_tpu_torch import convert
    port, inputs = syncbn
    cfg = ttrain.TrainConfig(model="TINY", strategy="none", augment=False)
    tree = {k: {} for k in ("p", "s")}
    for key, a in inputs.items():
        if key[:2] in ("p/", "s/"):
            _, k, n = key.split("/")
            tree[key[0]].setdefault(k, {})[n] = a
    params, state = convert.from_jax_vgg(tree["p"], tree["s"], device="cpu")
    params = {k: {n: t.requires_grad_(True) for n, t in v.items()}
              for k, v in params.items()}
    loss, new_state = ttrain._loss_fn(
        params, state, None, torch.from_numpy(inputs["images"]),
        torch.from_numpy(inputs["labels"]).long(), cfg=cfg)
    loss.backward()
    losses = [float(port[f"rank{r}:loss"]) for r in range(N_DEV)]
    np.testing.assert_allclose(np.mean(losses), float(loss.detach()),
                               rtol=1e-5)
    for k, n in ttrain.jax_order(params):
        want = params[k][n].grad.numpy()
        for r in range(N_DEV):
            got = port[f"rank{r}:grad/{k}/{n}"]
            scale = np.abs(want).max()
            # conv biases' gradients are rounding noise (BN cancels them)
            assert np.abs(got - want).max() <= 1e-5 * scale + 1e-6, \
                (k, n, r, np.abs(got - want).max(), scale)
    for k, v in new_state.items():
        for n, t in v.items():
            for r in range(N_DEV):
                np.testing.assert_allclose(port[f"rank{r}:state/{k}/{n}"],
                                           t.numpy(), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def checks(runs, tmp_path_factory):
    jax_out, _ = runs
    images, labels = _batch()
    inputs = {"images": images, "labels": labels}
    inputs.update({k[len("init/"):]: v for k, v in jax_out.items()
                   if k.startswith("init/")})
    return shared_result(tmp_path_factory, "torch_dp_checks", lambda: {
        f"rank{r}:{k}": v for r, out in enumerate(run_gang(
            "checks", inputs, str(tmp_path_factory.mktemp("checks_gang"))))
        for k, v in out.items()})


def test_check_consistency_passes_then_catches_a_perturbed_rank(checks):
    for r in range(N_DEV):
        assert bool(checks[f"rank{r}:consistent_after_steps"])
        assert bool(checks[f"rank{r}:raised_after_perturbation"])
        assert "fc.bias" in str(checks[f"rank{r}:message"])


def test_ranks_draw_different_crops(checks):
    """The same images on every rank: each rank's augmentation differs
    (the rank is in the generator's seed), and is the draw of
    ``augment_seed(seed, step, rank)``."""
    images, _ = _batch()
    for step in (0, 1):
        crops = [checks[f"rank{r}:crops{step}"] for r in range(N_DEV)]
        for a in range(N_DEV):
            for b in range(a + 1, N_DEV):
                assert not np.array_equal(crops[a], crops[b]), (step, a, b)
        for r in range(N_DEV):
            gen = torch.Generator().manual_seed(
                ttrain.augment_seed(1, step, r))
            want = taug.augment(gen, torch.from_numpy(
                images[:PER_DEV_BATCH]))
            assert np.array_equal(crops[r], want.numpy())
    assert ttrain.augment_seed(1, 5, 0) == ttrain.augment_seed(1, 5)


def test_vgg_apply_sync_bn_at_one_rank_is_local_bn():
    """A one-rank sync-BN group gives local BN's forward, gradients and
    state bitwise."""
    import torch.distributed as dist
    from distributed_pytorch_tpu_torch.parallel.mesh import make_mesh as mk
    from distributed_pytorch_tpu_torch.parallel import init as pinit
    created = not dist.is_initialized()
    mesh = mk(device="cpu")
    try:
        p0, s0 = tvgg.init(3, "TINY", device="cpu")
        x = taug.normalize(torch.from_numpy(_batch()[0][:4]))
        outs = []
        for group in (None, mesh.get_group()):
            p = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
                 for k, v in p0.items()}
            logits, st = tvgg.apply(p, s0, x, name="TINY", train=True,
                                    bn_axis_name=group)
            logits.sum().backward()
            outs.append((logits.detach(), st, p))
        assert torch.equal(outs[0][0], outs[1][0])
        for k in p0:
            for n in p0[k]:
                assert torch.equal(outs[0][2][k][n].grad,
                                   outs[1][2][k][n].grad)
        for k in s0:
            for n in s0[k]:
                assert torch.equal(outs[0][1][k][n], outs[1][1][k][n])
    finally:
        if created:
            pinit.shutdown()
