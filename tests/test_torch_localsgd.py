"""The port's sync windows (``sync_every = H > 1``, local SGD) against the
JAX package's, on the CPU, in 4-rank Gloo gangs (tests/workers/
torch_dp_worker.py).

**VGG** (modes ``train`` and ``counts``): TINY, lr 0.01, 4 images a
rank, no augmentation, one global batch every step (as tests/
test_torch_dp_train.py), ``steps_per_loop = 2``: two windows of H = 2
from the JAX trainer's initial params.  TINY trajectories are chaotic: a
BN output within float32 noise of 0 falls on the other side of a ReLU in
one package, and the packages part by ~lr from then on (tests/
test_torch_dp_train.py's docstring).  At lr 0.02, at eight steps or with
a batch a step, some run here parts within its window; so does one of
the six runs at data seeds 2 and 3 with this setting (seed 1, used, has
none).  The bands below hold a run that did not part.

- ``sync_every=1`` (with ``max_sync_every=4``) is bitwise the per-step
  run.
- Plain SGD (momentum 0, weight decay 0) under ``ddp``: the anchor equals
  JAX's windowed mesh trainer and the accumulated-update oracle (each
  replica's two SGD steps at its own ``anchor + delta``, from JAX's loss
  and optimizer without a mesh, the deltas averaged) within the JAX
  test's atol 2e-4 (tests/test_localsgd.py).
- Momentum SGD under ``ddp``, ``hierarchical`` (2 x 2), ``hierarchical``
  with ``dcn_compress="int8"`` and ``quantized_ring_ef``: losses, params,
  each rank's momentum and residual against JAX's windowed trainer.  On
  this JAX the windowed ``ddp`` and uncompressed ``hierarchical`` steps do
  not trace with the replication checker on (a BN state carry's varying
  axes); the oracle runs them with it off, as the JAX trainer runs its
  ring strategies (``_trace_unchecked``): the same program, unchecked.
  Bands: tests/test_torch_dp_train.py's (losses rtol 1e-5, params rtol
  1e-5 / atol 1e-6, momentum 1e-4 of its largest entry plus 1e-5) for the
  exact strategies.  The quantized exchanges round each delta to a level
  of its block (the largest |value| over 127), and an ulp of difference
  upstream can move a value one level: params within a level of the
  largest move at each of the two boundaries, losses at rtol 1e-4 (the
  first window's at 1e-5), the residual within n levels.

**LM** (mode ``lm``): tests/test_torch_fsdp.py's model and batch (rank 1
holds fewer valid targets) over ``("dcn", "data")`` = 2 x 2, four float32
steps from the JAX initial params.  The JAX window step's gradient is the
documented one (each slice's gradient of its own tokens at the full-batch
rate) times ``n_data`` on each leaf not sharded over ``data`` (its
``_local_sync_point`` sums what ``shard_map`` has summed; ROADMAP.md queue
3): measured with JAX alone, 2x at ``dp=4, dcn_size=2``, 1x at ``dp=4,
dcn_size=4``, 4x at ``dp=8, dcn_size=2``, and 1x under fsdp, where every
leaf here is sharded.  ``test_reference_window_gradient_scale`` holds it.
The port computes the documented gradient; the oracle is JAX's trainer
with its gradient divided by that factor before its optimizer
(``jax_lm_run``), so the clip and Adam see the same values in both:
``sync_every`` 2 and 4, ``fsdp``, ``dcn_compress`` int8 and int4 (the
residual of the exchanged deltas against JAX's row), ``staleness=1``
(its live delta, an exchange launched and not applied, against JAX's
row).  Losses rtol 1e-5 (1e-4 quantized), params, Adam's mu and the
delta in tests/test_torch_fsdp.py's bands, Adam's nu (squares) within
1e-4 of each tensor's largest entry.  ``overlap`` runs are bitwise their
own non-overlapped runs.

**Collectives** (mode ``counts``): the calls and bytes a rank issues a
process group at a time over four steps.  A flat strategy's windowed
local steps issue none (ddp with ``broadcast_buffers=False``: one
exchange a window against one sync a step); hierarchical's keep their
within-slice ``ici`` hops and cross ``dcn`` once a window; the LM window
sends ``dcn`` 0.25x the bytes of the per-step two-level sync at H=4 (the
JAX claim: at most 0.27x) and no byte over ``dcn`` inside the window.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import lm as jlm
from distributed_pytorch_tpu import train as jtrain
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu.parallel.mesh import make_mesh
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import lm as tlm
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from test_torch_fsdp import (N, SHAPE, _batch, _flat_names, _init,
                             assert_params_in_band)
from workers.torch_dp_worker import run_gang, shared_result

# -- VGG ----------------------------------------------------------------------

H = 2
VSTEPS = 4
PER_DEV = 4
VLR = 0.01
VBASE = dict(model="TINY", batch_size=PER_DEV, augment=False, lr=VLR)
WIN = dict(sync_every=H, max_sync_every=H, steps_per_loop=H)
VCASES = {
    "per_step": dict(strategy="ddp", steps_per_loop=H),
    "h1": dict(strategy="ddp", steps_per_loop=H, sync_every=1,
               max_sync_every=H),
    "plain": dict(strategy="ddp", momentum=0.0, weight_decay=0.0, **WIN),
    "ddp": dict(strategy="ddp", **WIN),
    "hierarchical": dict(strategy="hierarchical", dcn_size=2, **WIN),
    "hierarchical_int8": dict(strategy="hierarchical", dcn_size=2,
                              dcn_compress="int8", **WIN),
    "quantized_ring_ef": dict(strategy="quantized_ring_ef", **WIN),
}
VQUANT = ("hierarchical_int8", "quantized_ring_ef")
TOL = dict(rtol=1e-5, atol=1e-6)
MOMENTUM_NOISE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vgg_batches(steps: int = VSTEPS):
    """One global batch (4 ranks x 4 images) every step, as tests/
    test_torch_dp_train.py repeats its own: (steps, 16, ...)."""
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (N * PER_DEV, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, N * PER_DEV).astype(np.int32)
    return np.stack([images] * steps), np.stack([labels] * steps)


def _vflat(prefix: str, tree) -> dict:
    return {f"{prefix}/{k}/{n}": np.asarray(a) for k, v in tree.items()
            for n, a in v.items()}


def _trace_unchecked(tr) -> None:
    """Build the JAX trainer's step with the replication checker off (as
    for its ring strategies): this JAX does not trace the windowed ddp and
    uncompressed hierarchical steps with it on."""
    s = tr.strategy
    s.vma_opaque = True
    if hasattr(s, "set_dcn"):
        set_dcn = s.set_dcn

        def keep_unchecked(compress, dcn_size):
            set_dcn(compress, dcn_size)
            s.vma_opaque = True
        s.set_dcn = keep_unchecked


def jax_vgg_trainer(kw: dict):
    cfg = jtrain.TrainConfig(**VBASE, **kw)
    if kw["strategy"] == "hierarchical":
        tr = jtrain.Trainer(cfg, num_devices=N)
    else:
        tr = jtrain.Trainer(cfg, make_mesh(N))
    _trace_unchecked(tr)
    return tr


def jax_vgg_run(kw: dict, images, labels, steps_per_call: int = H) -> dict:
    """The JAX windowed trainer of ``kw``: losses, params, each replica's
    momentum (the windowed trainer stacks it a device a row) and residual
    after ``len(images)`` steps."""
    tr = jax_vgg_trainer(kw)
    losses = []
    for c in range(0, len(images), steps_per_call):
        losses += np.asarray(tr.train_steps(
            images[c:c + steps_per_call],
            labels[c:c + steps_per_call])).tolist()
    out = {"losses": np.asarray(losses)}
    out.update(_vflat("p", jax.tree.map(np.asarray, tr.params)))
    trace = [s for s in jax.tree.leaves(
        tr.opt_state, is_leaf=lambda x: hasattr(x, "trace"))
        if hasattr(s, "trace")][0].trace
    out.update(_vflat("m", jax.tree.map(np.asarray, trace)))
    out["sync_state"] = np.asarray(tr.sync_state)
    return out


def vgg_init() -> dict:
    """The JAX trainer's initial params and BN state (``init/p/...``,
    ``init/s/...``)."""
    tr = jtrain.Trainer(jtrain.TrainConfig(**VBASE, strategy="ddp"),
                        make_mesh(N))
    out = _vflat("init/p", jax.tree.map(np.asarray, tr.params))
    out.update(_vflat("init/s", tr.eval_state()))
    return out


def vgg_jax(tmp_path_factory, tag: str, cases: dict, name: str) -> dict:
    """JAX's windowed run of ``cases[name]`` (``"oracle"``: the
    accumulated-update oracle of the plain window) beside the JAX initial
    params, each a shared result of its own, so that the xdist workers
    compute them side by side."""
    init = shared_result(tmp_path_factory, "torch_window_vgg_init",
                         vgg_init)
    images, labels = vgg_batches()

    def compute():
        run = _accumulated_oracle(init, images, labels) \
            if name == "oracle" else jax_vgg_run(cases[name], images, labels)
        return {f"{name}/{k}": v for k, v in run.items()}
    return {**init, **shared_result(tmp_path_factory, f"{tag}_{name}",
                                    compute)}


def _accumulated_oracle(init: dict, images, labels) -> dict:
    """Plain-SGD windows from JAX's loss and optimizer without a mesh:
    each replica runs H ``tx.update`` steps at its own ``anchor + delta``
    on its rows, the anchor moves by the mean of the deltas."""
    import jax.numpy as jnp
    from functools import partial
    cfg = jtrain.TrainConfig(**VBASE, **VCASES["plain"])
    tree = {"p": {}, "s": {}}
    for key, a in init.items():
        if key.startswith("init/"):
            _, tag, k, n = key.split("/")
            tree[tag].setdefault(k, {})[n] = jnp.asarray(a)
    params, state = tree["p"], tree["s"]
    tx = jtrain.make_optimizer(cfg)
    grad = jax.jit(jax.grad(lambda p, s, x, y: partial(
        jtrain._loss_fn, cfg=cfg, bn_axis=None)(
            p, s, jax.random.key(0), x, y)[0]))
    for w in range(VSTEPS // H):
        deltas = []
        for d in range(N):
            delta = jax.tree.map(jnp.zeros_like, params)
            opt_state = tx.init(params)
            rows = slice(d * PER_DEV, (d + 1) * PER_DEV)
            for t in range(w * H, (w + 1) * H):
                local = jax.tree.map(jnp.add, params, delta)
                g = grad(local, state, jnp.asarray(images[t, rows]),
                         jnp.asarray(labels[t, rows]))
                updates, opt_state = tx.update(g, opt_state, local)
                delta = jax.tree.map(jnp.add, delta, updates)
            deltas.append(delta)
        params = jax.tree.map(lambda p, *ds: p + sum(ds) / N, params,
                              *deltas)
    return _vflat("p", jax.tree.map(np.asarray, params))


def vgg_gang(tmp_path_factory, init: dict, cases: dict, tag: str) -> dict:
    images, labels = vgg_batches()
    inputs = {"images": images, "labels": labels}
    inputs.update({k[len("init/"):]: v for k, v in init.items()
                   if k.startswith("init/")})
    ranks = run_gang("train", inputs, str(tmp_path_factory.mktemp(tag)),
                     cases={n: dict(cfg=dict(VBASE, **kw), steps=VSTEPS,
                                    steps_per_call=H)
                            for n, kw in cases.items()})
    return {f"rank{r}:{k}": v for r, o in enumerate(ranks)
            for k, v in o.items()}


def _vgg_runs(tmp_path_factory, *names) -> tuple[dict, dict]:
    """(JAX's runs of ``names``, the port's gang over every case); the
    JAX runs first, so that one worker's gang overlaps the others'."""
    jax_out = {}
    for name in names:
        jax_out.update(vgg_jax(tmp_path_factory, "torch_localsgd_vgg_jax",
                               VCASES, name))
    init = shared_result(tmp_path_factory, "torch_window_vgg_init",
                         vgg_init)
    port = shared_result(tmp_path_factory, "torch_localsgd_vgg_port",
                         lambda: vgg_gang(tmp_path_factory, init, VCASES,
                                          "localsgd_vgg"))
    return jax_out, port


def _vkeys(jax_out, name, tag):
    return sorted(k for k in jax_out if k.startswith(f"{name}/{tag}/"))


def test_vgg_sync_every_1_is_bitwise_the_per_step_run(tmp_path_factory):
    _, port = _vgg_runs(tmp_path_factory)
    keys = [k for k in port if ":per_step/" in k]
    assert len(keys) > 4 * 10
    for k in keys:
        assert np.array_equal(port[k], port[k.replace(":per_step/", ":h1/")]
                              ), k


def test_vgg_plain_sgd_window_equals_jax_and_the_oracle(tmp_path_factory):
    jax_out, port = _vgg_runs(tmp_path_factory, "plain", "oracle")
    keys = _vkeys(jax_out, "plain", "p")
    assert keys
    moved = 0.0
    for k in keys:
        got = port[f"rank0:{k}"]
        for r in range(1, N):
            assert np.array_equal(port[f"rank{r}:{k}"], got), (k, r)
        np.testing.assert_allclose(got, jax_out[k], atol=2e-4, err_msg=k)
        want = jax_out[k.replace("plain/", "oracle/")]
        np.testing.assert_allclose(got, want, atol=2e-4, err_msg=k)
        init = jax_out["init/" + k[len("plain/"):]]
        moved = max(moved, float(np.abs(want - init).max()))
    assert moved > 1e-2  # the windows moved the params well past the band
    for r in range(N):
        np.testing.assert_allclose(port[f"rank{r}:plain/losses"],
                                   jax_out["plain/losses"], rtol=1e-5)


@pytest.mark.parametrize("name", ("ddp", "hierarchical"))
def test_vgg_momentum_window_equals_jax(tmp_path_factory, name):
    """Losses, the replicated anchor, and each rank's own momentum (which
    stays on the rank across windows) against JAX's windowed trainer."""
    jax_out, port = _vgg_runs(tmp_path_factory, name)
    for r in range(N):
        np.testing.assert_allclose(port[f"rank{r}:{name}/losses"],
                                   jax_out[f"{name}/losses"], rtol=1e-5)
    for k in _vkeys(jax_out, name, "p"):
        for r in range(N):
            assert np.array_equal(port[f"rank{r}:{k}"], port[f"rank0:{k}"])
        np.testing.assert_allclose(port[f"rank0:{k}"], jax_out[k],
                                   err_msg=k, **TOL)
    distinct = False
    for k in _vkeys(jax_out, name, "m"):
        for r in range(N):
            want = jax_out[k][r]
            err = np.abs(port[f"rank{r}:{k}"] - want).max()
            assert err <= MOMENTUM_NOISE * np.abs(want).max() + 1e-5, \
                (k, r, err)
            distinct |= not np.array_equal(want, jax_out[k][0])
    assert distinct  # local momentum: the replicas' buffers differ


@pytest.mark.parametrize("name", VQUANT)
def test_vgg_quantized_window_equals_jax(tmp_path_factory, name):
    """The quantized exchanges carry the window's delta, whose largest
    |value| is at most the params' largest move: params within a quantum
    of it (that over 127) at each of the two boundaries, a value an ulp
    from a rounding boundary landing a level apart; the residual within n
    quanta (the ranks' summed values)."""
    jax_out, port = _vgg_runs(tmp_path_factory, name)
    for r in range(N):
        got, want = port[f"rank{r}:{name}/losses"], \
            jax_out[f"{name}/losses"]
        np.testing.assert_allclose(got[:H], want[:H], rtol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-4)
    worst, moved = 0.0, 0.0
    for k in _vkeys(jax_out, name, "p"):
        got = port[f"rank0:{k}"]
        for r in range(N):
            assert np.array_equal(port[f"rank{r}:{k}"], got)
        worst = max(worst, float(np.abs(got - jax_out[k]).max()))
        moved = max(moved, float(np.abs(
            jax_out[k] - jax_out["init/" + k[len(name) + 1:]]).max()))
    # the exchanged value is the window's delta, |delta| <= moved; one
    # quantum of it at each of the two boundaries
    quantum = moved / 127.0
    assert 0 <= worst <= 2 * quantum, (worst, quantum)
    for r in range(N):
        got = port[f"rank{r}:{name}/sync_state"]
        want = jax_out[f"{name}/sync_state"][r]
        assert got.shape == want.shape
        assert np.abs(want).max() > 0
        assert np.abs(got - want).max() <= N * quantum, r


# -- LM -----------------------------------------------------------------------

LSTEPS = 4
LCASES = {
    "w2": dict(model=SHAPE, cfg=dict(dcn_size=2, sync_every=2)),
    "w4": dict(model=SHAPE, cfg=dict(dcn_size=2, sync_every=4)),
    "w2_fsdp": dict(model=SHAPE, cfg=dict(dcn_size=2, sync_every=2,
                                          fsdp=True)),
    "w2_int8": dict(model=SHAPE, cfg=dict(dcn_size=2, sync_every=2,
                                          dcn_compress="int8")),
    "w2_int4": dict(model=SHAPE, cfg=dict(dcn_size=2, sync_every=2,
                                          dcn_compress="int4")),
    "w2_staleness1": dict(model=SHAPE, cfg=dict(dcn_size=2, sync_every=2,
                                                staleness=1)),
    "w2_overlap": dict(model=SHAPE, cfg=dict(dcn_size=2, sync_every=2,
                                             overlap=True)),
    "w2_fsdp_overlap": dict(model=SHAPE, cfg=dict(
        dcn_size=2, sync_every=2, fsdp=True, overlap=True)),
}
LJAX = ("w2", "w4", "w2_fsdp", "w2_int8", "w2_int4", "w2_staleness1")
LQUANT = ("w2_int8", "w2_int4")
OVERLAP = {"w2_overlap": "w2", "w2_fsdp_overlap": "w2_fsdp"}
N_DATA = N // 2  # the reference's extra factor on a leaf not over data


def reference_factors(cfg) -> dict:
    """The JAX window gradient over the documented one, a leaf at a time
    (JAX's flat names): ``n_data`` for a leaf not sharded over ``data``
    (its intra-slice ``psum`` re-sums what ``shard_map`` summed), 1 for a
    ZeRO-3 leaf (the gather's transpose did its sum).  Measured with JAX
    alone: 2 at ``dp=4, dcn_size=2``, 1 at ``dp=4, dcn_size=4``, 4 at
    ``dp=8, dcn_size=2``; every leaf of this model is sharded under fsdp
    at 2 x 2, and its window gradient is then the documented one."""
    specs = jlm.param_specs(cfg)
    return {k: 1.0 if "data" in str(v) else float(cfg.dp // cfg.dcn_size)
            for k, v in _flat_names(specs).items()}


def jax_lm_run(case: dict, steps: int = LSTEPS) -> dict:
    """The JAX windowed LM trainer of ``case`` on the 4-device mesh, its
    gradient divided by ``reference_factors`` before the optimizer (an
    optax scale chained in front of its own, in this process only): the
    documented gradient, so its clip and Adam see the port's values.  The
    losses and metrics of every step (the metrics read the undivided
    gradient), then the params, the ``dcn``-stacked Adam moments and
    delta, the outer momentum and the residual."""
    import optax
    tokens, targets = _batch()
    cfg = jlm.LMTrainConfig(model=jtfm.TransformerConfig(**case["model"]),
                            compute_dtype=None, dp=N, **case["cfg"])
    factors = reference_factors(cfg)
    names = list(_flat_names(jlm.param_specs(cfg)))
    make = jlm.make_optimizer

    def divided(c):
        def scale(updates, params=None):
            leaves, tree = jax.tree.flatten(updates)
            return jax.tree.unflatten(tree, [
                g * np.float32(1.0 / factors[n])
                for g, n in zip(leaves, names)])
        return optax.chain(optax.stateless(scale), make(c))

    jlm.make_optimizer = divided
    try:
        tr = jlm.LMTrainer(cfg)
    finally:
        jlm.make_optimizer = make
    losses, mets = [], []
    for _ in range(steps):
        losses.append(float(tr.train_step(tokens, targets)))
        mets.append(np.asarray(tr.last_metrics))
    out = {"losses": np.asarray(losses), "met": np.stack(mets)}
    out.update({f"p/{k}": np.asarray(v)
                for k, v in _flat_names(tr.params).items()})
    adam = [s for s in jax.tree.leaves(
        tr.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    for m in ("mu", "nu"):
        out.update({f"{m}/{k}": np.asarray(v) for k, v in
                    _flat_names(getattr(adam[0], m)).items()})
    out.update({f"delta/{k}": np.asarray(v)
                for k, v in _flat_names(tr._delta).items()})
    if tr._outer_m is not None:
        out.update({f"outer_m/{k}": np.asarray(v)
                    for k, v in _flat_names(tr._outer_m).items()})
    if tr.sync_state is not None:
        out["sync_state"] = np.asarray(tr.sync_state)
    return out


def lm_gang(tmp_path_factory, cases: dict, tag: str,
            steps: int = LSTEPS) -> dict:
    """The port's LM gang over every case, each from the JAX initial
    params of its model: ``rank{r}:{case}/...`` arrays."""
    tokens, targets = _batch()
    inputs = {"tokens": tokens, "targets": targets}
    inputs.update({f"p/{k}": v for k, v in _init(SHAPE).items()})
    ranks = run_gang(
        "lm", inputs, str(tmp_path_factory.mktemp(tag)), world=N,
        cases={n: dict(c, steps=c.get("steps", steps))
               for n, c in cases.items()})
    return {f"rank{r}:{k}": v for r, o in enumerate(ranks)
            for k, v in o.items()}


def window_state(port: dict, name: str, tag: str, cfg: dict) -> dict:
    """A port gang's ``tag`` state (delta, mu, nu, outer_m) back in JAX's
    ``dcn``-stacked layout, flat-named."""
    pcfg = tlm.LMTrainConfig(model=ttfm.TransformerConfig(**SHAPE), dp=N,
                             **cfg)
    dims = {n: tlm.fsdp_dim(sp) for n, sp in tlm.param_specs(pcfg).items()}
    pre = f"{name}/{tag}/"
    shards = [{k.split(":", 1)[1][len(pre):]: v for k, v in port.items()
               if k.startswith(f"rank{r}:{pre}")} for r in range(N)]
    stacked = convert.to_jax_window_stacked(shards, dims, cfg["dcn_size"])
    return _flat_names(stacked)


def _lm_port(tmp_path_factory) -> dict:
    """The module's LM gang over every case (the tests fetch their JAX
    runs first, so that one worker's gang overlaps the others' JAX)."""
    return shared_result(tmp_path_factory, "torch_localsgd_lm_port",
                         lambda: lm_gang(tmp_path_factory, LCASES,
                                         "localsgd_lm"))


def _lm_jax(tmp_path_factory, name: str) -> dict:
    return shared_result(tmp_path_factory, f"torch_localsgd_lm_jax_{name}",
                         lambda: jax_lm_run(LCASES[name]))


def assert_state_in_band(got: dict, want: dict, what: str,
                         quantized: bool = False):
    """Window state (an Adam moment, a delta, an outer momentum) stacked a
    slice a row: every tensor in the params' band."""
    assert got.keys() == want.keys() and got, what
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        assert_params_in_band(got[k], want[k], f"{what} {k}",
                              quantized=quantized)


@pytest.mark.parametrize("name", LJAX)
def test_lm_window_equals_jax(tmp_path_factory, name):
    jax_out = _lm_jax(tmp_path_factory, name)
    port = _lm_port(tmp_path_factory)
    quant = name in LQUANT
    for r in range(N):
        np.testing.assert_allclose(port[f"rank{r}:{name}/losses"],
                                   jax_out["losses"],
                                   rtol=1e-4 if quant else 1e-5)
    keys = sorted(k[len("p/"):] for k in jax_out if k.startswith("p/"))
    assert keys
    for k in keys:
        got = port[f"rank0:{name}/p/{k}"]
        assert_params_in_band(got, jax_out[f"p/{k}"], k, quantized=quant)
        for r in range(1, N):
            assert np.array_equal(port[f"rank{r}:{name}/p/{k}"], got)
    cfg = LCASES[name]["cfg"]
    for tag in ("mu", "nu", "delta"):
        want = {k[len(tag) + 1:]: v for k, v in jax_out.items()
                if k.startswith(tag + "/")}
        got = window_state(port, name, tag, cfg)
        if tag == "delta" and name != "w2_staleness1":
            # every run ends on a boundary: the delta is zero
            assert not any(v.any() for v in got.values())
            assert not any(v.any() for v in want.values())
        elif tag == "nu":  # squares: float32 noise relative to the largest
            for k in want:
                err = np.abs(got[k] - want[k]).max()
                assert err <= 1e-4 * np.abs(want[k]).max(), (k, err)
        else:
            assert_state_in_band(got, want, tag, quantized=quant)
    if name == "w2_staleness1":  # a launched exchange not yet applied
        assert any(v.any() for k, v in jax_out.items()
                   if k.startswith("delta/"))


@pytest.mark.parametrize("name", LQUANT)
def test_lm_window_residual_equals_jax_rows(tmp_path_factory,
                                            name):
    """The residual of the quantized delta exchange: JAX's layout (the
    whole tree's partition) and JAX's row to float32 noise but for values
    at a rounding boundary, each within a level (tests/
    test_torch_dcn_sync.py's criterion, whose 99% share of noise-level
    entries is 90% here: a window's delta is a sum of Adam steps of about
    lr each, so many values sit near the same multiples of a block's
    level, and a float32 ulp moves more of them across a boundary;
    measured 94.4-97.4% at int8)."""
    jax_out = _lm_jax(tmp_path_factory, name)
    lm_port = _lm_port(tmp_path_factory)
    want_all = jax_out["sync_state"]
    assert want_all.shape[1] == tlm.lm_sync_state_len(tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**SHAPE), dp=N, **LCASES[name]["cfg"]))
    for r in range(N):
        got = lm_port[f"rank{r}:{name}/sync_state"]
        want = want_all[r]
        assert got.shape == want.shape
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got - want).max() <= 2 * scale * (1 + 1e-3), r
        noise = np.abs(got - want) <= 1e-3 * scale
        assert noise.mean() >= 0.9, (r, noise.mean())


@pytest.mark.parametrize("name", OVERLAP)
def test_lm_overlap_window_is_bitwise_the_non_overlapped_run(tmp_path_factory, name):
    ref = OVERLAP[name]
    lm_port = _lm_port(tmp_path_factory)
    keys = [k for k in lm_port if f":{ref}/" in k]
    assert keys
    for k in keys:
        assert np.array_equal(lm_port[k.replace(f":{ref}/", f":{name}/")],
                              lm_port[k]), k


def test_reference_window_gradient_scale(tmp_path_factory):
    """The first step's grad-norm (before any trajectory differs): JAX's
    window gradient is n_data (2 here) times the port's without fsdp, and
    the port's under fsdp, where every leaf of this model is a ZeRO-3
    leaf: the reference fault the oracles divide out (ROADMAP.md queue
    3).  The port's is each slice's gradient of its own tokens at the
    full-batch rate, the norm over both slices' gradients."""
    for name, factor in (("w2", N_DATA), ("w2_fsdp", 1.0)):
        jax_out = _lm_jax(tmp_path_factory, name)
        lm_port = _lm_port(tmp_path_factory)
        for r in range(N):
            got = lm_port[f"rank{r}:{name}/met"][0]
            np.testing.assert_allclose(got[0] * factor,
                                       jax_out["met"][0][0], rtol=1e-5)
            np.testing.assert_allclose(got[1], jax_out["met"][0][1],
                                       rtol=1e-5)


# -- the collectives a window issues, by group ---------------------------------

CH = 4  # the counted runs: four steps, one window of 4
CWIN = dict(sync_every=CH, max_sync_every=CH, steps_per_loop=CH)
COUNT_CASES = {
    "vgg_ddp_h1": dict(kind="vgg", steps=CH, cfg=dict(
        VBASE, strategy="ddp", broadcast_buffers=False, steps_per_loop=CH)),
    "vgg_ddp_h4": dict(kind="vgg", steps=CH, cfg=dict(
        VBASE, strategy="ddp", broadcast_buffers=False, **CWIN)),
    "vgg_hier_h1": dict(kind="vgg", steps=CH, cfg=dict(
        VBASE, strategy="hierarchical", dcn_size=2, steps_per_loop=CH)),
    "vgg_hier_h4": dict(kind="vgg", steps=CH, cfg=dict(
        VBASE, strategy="hierarchical", dcn_size=2, **CWIN)),
    "lm_h1": dict(kind="lm", steps=CH, model=SHAPE, cfg=dict(dcn_size=2)),
    "lm_h4": dict(kind="lm", steps=CH, model=SHAPE, cfg=dict(
        dcn_size=2, sync_every=CH)),
}
WORLD = "0,1,2,3"


def _groups(rank: int) -> tuple[str, str]:
    """(dcn group, data group) of ``rank`` on the 2 x 2 mesh."""
    return (("0,2", "1,3")[rank % 2], ("0,1", "2,3")[rank // 2])


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    def compute():
        images, labels = vgg_batches(CH)
        tokens, targets = _batch()
        inputs = {"images": images, "labels": labels, "tokens": tokens,
                  "targets": targets}
        ranks = run_gang("counts", inputs,
                         str(tmp_path_factory.mktemp("localsgd_counts")),
                         world=N, cases=COUNT_CASES)
        return {f"rank{r}:{k}": v for r, o in enumerate(ranks)
                for k, v in o.items()}
    return shared_result(tmp_path_factory, "torch_localsgd_counts", compute)


def _count(counts, name, group, what="calls", rank=0) -> int:
    return int(counts.get(f"rank{rank}:{name}/{what}/{group}", 0))


def test_flat_window_local_steps_issue_no_collective(counts):
    """ddp over 4 steps: a sync a step per-step, one exchange in the
    window; both add the one all-reduce a ``train_steps`` call makes of
    its losses and scalars.  No other group is used."""
    for r in range(N):
        assert _count(counts, "vgg_ddp_h1", WORLD, rank=r) == CH + 1
        assert _count(counts, "vgg_ddp_h4", WORLD, rank=r) == 1 + 1
    keys = {k.split("/", 2)[2] for k in counts if "vgg_ddp" in k}
    assert keys == {WORLD}, keys


def test_hierarchical_window_crosses_dcn_once(counts):
    """The per-step two-level sync: a reduce-scatter and an all-gather
    over ici and an all-reduce over dcn a step.  The window keeps the
    within-slice hops every step and crosses dcn once, at the boundary
    (the chunk each rank takes needs no reduce-scatter there)."""
    for r in range(N):
        dcn, ici = _groups(r)
        assert _count(counts, "vgg_hier_h1", dcn, rank=r) == CH
        assert _count(counts, "vgg_hier_h4", dcn, rank=r) == 1
        assert _count(counts, "vgg_hier_h1", ici, rank=r) == 2 * CH
        assert _count(counts, "vgg_hier_h4", ici, rank=r) == 2 * CH + 1
        assert _count(counts, "vgg_hier_h4", dcn, "bytes", rank=r) * CH \
            == _count(counts, "vgg_hier_h1", dcn, "bytes", rank=r)


def test_lm_window_dcn_bytes_scale_inverse_h(counts):
    """The JAX claim (tests/test_localsgd.py): at H=4 the dcn bytes a step
    are at most 0.27x the per-step path's (0.25x: the same shard-sized
    exchange, once a window), no byte crosses dcn inside the window, and
    the fast-axis bytes stay in a band (the local steps' all-reduce of the
    replicated gradients against the per-step reduce-scatter and
    all-gather)."""
    for r in range(N):
        dcn, data = _groups(r)
        d1 = _count(counts, "lm_h1", dcn, "bytes", rank=r)
        d4 = _count(counts, "lm_h4", dcn, "bytes", rank=r)
        assert d1 > 0 and d4 * CH == d1, (r, d1, d4)
        assert d4 / d1 <= 0.27
        assert _count(counts, "lm_h4", dcn, rank=r) * CH == _count(
            counts, "lm_h1", dcn, rank=r)
        i1 = _count(counts, "lm_h1", data, "bytes", rank=r)
        i4 = _count(counts, "lm_h4", data, "bytes", rank=r)
        assert 0.5 < i4 / i1 < 1.3, (r, i1, i4)


# -- the window state's converters ----------------------------------------------

def test_window_state_converters_cross_jax_rows():
    """``from_jax_window_row`` gives each rank its slice's row of a
    ``dcn``-stacked JAX tree, cut to its ZeRO-3 shard; over a gang
    ``to_jax_window_stacked`` puts the rows back bitwise.  A windowed JAX
    VGG trainer's per-device momentum crosses a rank at a time
    (``from_jax_replica_sgd_state``)."""
    cfg = tlm.LMTrainConfig(model=ttfm.TransformerConfig(**SHAPE), dp=N,
                            dcn_size=2, fsdp=True)
    dims = {n: tlm.fsdp_dim(sp) for n, sp in tlm.param_specs(cfg).items()}
    shapes = tlm.param_shapes(cfg.model)
    rng = np.random.default_rng(3)
    stacked = convert.to_jax_params({n: torch.from_numpy(
        rng.standard_normal((2,) + tuple(s)).astype(np.float32))
        for n, s in shapes.items()})
    rows = [convert.from_jax_window_row(stacked, r // 2, dims, r, 2,
                                        device="cpu") for r in range(N)]
    assert any(dims.values())
    for n, d in dims.items():
        if d is not None:
            assert rows[1][n].shape[d] * 2 == shapes[n][d]
    back = convert.to_jax_window_stacked(rows, dims, 2)
    want, got = _flat_names(stacked), _flat_names(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # VGG: a windowed JAX trainer's momentum, stacked a device a row
    tr = jax_vgg_trainer(dict(VCASES["ddp"]))
    trace = [s for s in jax.tree.leaves(
        tr.opt_state, is_leaf=lambda x: hasattr(x, "trace"))
        if hasattr(s, "trace")][0].trace
    bumped = jax.tree.map(lambda a: np.asarray(a) + np.arange(
        N, dtype=np.float32).reshape((N,) + (1,) * (a.ndim - 1)),
        tr.opt_state)
    for r in range(N):
        m = convert.from_jax_replica_sgd_state(bumped, r, device="cpu")
        for k, v in trace.items():
            for n in v:
                got = convert.to_jax_vgg({k: {n: m[k][n]}}, {})[0][k][n]
                np.testing.assert_array_equal(
                    got, np.asarray(v[n])[r] + r)


# -- Hierarchical's window halves, on shared values ------------------------------

WINDOW_OPS = {
    "local_sync": dict(op="local_sync", compress=None, bucket_mb=25),
    "exchange": dict(op="exchange", compress=None, bucket_mb=25),
    "exchange_small": dict(op="exchange", compress=None, bucket_mb=0.002),
    "exchange_int8": dict(op="exchange", compress="int8", bucket_mb=25),
    "exchange_int8_small": dict(op="exchange", compress="int8",
                                bucket_mb=0.002),
    "exchange_int4": dict(op="exchange", compress="int4", bucket_mb=25),
}


def _window_inputs() -> dict:
    """Per-rank rows in JAX tree order (a bias, an HWIO conv kernel, a
    dense kernel: 3,265 values): ``g`` a row a rank, ``d`` and ``e`` a row
    a slice (a window's delta is equal within its slice)."""
    rng = np.random.default_rng(9)
    shapes = ((13,), (3, 3, 8, 16), (300, 7))
    out = {}
    for i, shape in enumerate(shapes):
        out[f"g{i}"] = rng.standard_normal((N,) + shape).astype(np.float32)
        for prefix in ("d", "e"):
            rows = rng.standard_normal((2,) + shape).astype(np.float32)
            out[f"{prefix}{i}"] = np.repeat(rows, N // 2, axis=0)
    return out


def _jax_window_ops() -> dict:
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from distributed_pytorch_tpu.parallel import strategies as jstrat
    from distributed_pytorch_tpu.utils.compat import shard_map
    inputs = _window_inputs()
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(2, 2), ("dcn", "ici"))
    axes = ("dcn", "ici")

    def run(fn, *trees):
        def body(*ts):
            local = [jax.tree.map(lambda x: x[0], t) for t in ts]
            return jax.tree.map(lambda x: x[None], fn(*local))
        return jax.jit(shard_map(body, mesh=mesh,
                                 in_specs=(P(axes),) * len(trees),
                                 out_specs=P(axes), check_vma=False))(*trees)

    def tree(prefix):
        return [inputs[f"{prefix}{i}"] for i in range(3)]

    out = {}
    for name, case in WINDOW_OPS.items():
        s = jstrat.Hierarchical(dcn_compress=case["compress"], dcn_size=2,
                                bucket_mb=case["bucket_mb"])
        if case["op"] == "local_sync":
            rounds = [run(lambda t: s.local_sync(t, axes), tree("g"))]
        else:
            rounds = []
            res = None
            if case["compress"]:
                res = np.zeros((N,) + s.init_state(
                    [x[0] for x in tree("d")], N).shape, np.float32)
            for r, prefix in enumerate(("d", "e")):
                if case["compress"]:
                    synced, res = run(lambda t, st: s.window_exchange(
                        t, axes, st), tree(prefix), jnp.asarray(res))
                    res = np.asarray(res)
                    out[f"{name}{r}/res"] = res
                else:
                    synced = run(lambda t: s.window_exchange(t, axes),
                                 tree(prefix))
                rounds.append(synced)
        for r, synced in enumerate(rounds):
            for i, leaf in enumerate(jax.tree.leaves(synced)):
                out[f"{name}{r}/{i}"] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def window_ops(tmp_path_factory):
    jax_out = shared_result(tmp_path_factory, "torch_localsgd_window_jax",
                            _jax_window_ops)
    port = shared_result(tmp_path_factory, "torch_localsgd_window_port",
                         lambda: {f"rank{r}:{k}": v for r, o in enumerate(
                             run_gang("window", _window_inputs(),
                                      str(tmp_path_factory.mktemp(
                                          "localsgd_window")),
                                      world=N, cases=WINDOW_OPS))
                             for k, v in o.items()})
    return jax_out, port


@pytest.mark.parametrize("name", WINDOW_OPS)
def test_hierarchical_window_ops_bitwise_equal_jax(window_ops, name):
    """``local_sync`` (the within-slice mean) and ``window_exchange`` (each
    rank's ici chunk, the dcn exchange, the ici all-gather, / n_dcn;
    plain, in small buckets, and with the int8 / int4 ring over two rounds
    carrying the residual) bitwise the JAX ones under ``shard_map`` on
    shared values: the sums have two addends, whatever their order."""
    jax_out, port = window_ops
    keys = sorted(k for k in jax_out if k.startswith(name) and
                  k[len(name)].isdigit())
    assert len(keys) >= 3
    for k in keys:
        for r in range(N):
            got, want = port[f"rank{r}:{k}"], jax_out[k][r]
            assert got.shape == want.shape, (k, r)
            assert np.array_equal(got, want), \
                (k, r, float(np.abs(got - want).max()))
    if WINDOW_OPS[name]["compress"]:
        assert np.abs(jax_out[f"{name}1/res"]).max() > 0
