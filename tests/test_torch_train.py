"""The port's VGG training slice (distributed_pytorch_tpu_torch: train.py,
eval.py, cli.py, data/, utils/metrics.py, convert.py's SGD state) against
the JAX package's, on the CPU in float32.

The trainer comparison runs the JAX suite's single-device TINY setup
(tests/test_train.py: synthetic split seed 0, batch 32, no augmentation,
shuffled loader seed 0) at lr 0.02, from the JAX trainer's initial params
(convert.py).  Two packages that sum in different orders give float32
noise, and at lr 0.1 or 0.05 a BN output within ~1e-6 of 0 then falls on
the other side of the ReLU in one of them (seen at |y| 1.6e-6, depending
on torch's thread count), after which the two trajectories part by 1e-4
or more; at lr 0.02 the five steps stay within float32 noise for 1, 2, 4
and 8 threads.  Held: losses at rtol 1e-5 for the first step and 1e-4 over
five; every single step started from the JAX state (params, BN state,
momentum) to 1e-4 of each tensor's largest entry (plus 1e-5: the conv
biases' gradients are rounding noise, BN cancels them); after five free
steps params, BN state and momentum within 1e-3, 1e-4 and 1e-2 of each
tensor's largest entry (measured 2.3e-4, 4.8e-6, 1.9e-3).
"""

import dataclasses
import os

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_pytorch_tpu import eval as jeval
from distributed_pytorch_tpu import train as jtrain
from distributed_pytorch_tpu.data import augment as jaug
from distributed_pytorch_tpu.data import cifar10 as jcifar
from distributed_pytorch_tpu.data import pipeline as jpipe
from distributed_pytorch_tpu.data import sampler as jsampler
from distributed_pytorch_tpu.utils import metrics as jmetrics
from distributed_pytorch_tpu_torch import cli as tcli
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import eval as teval
from distributed_pytorch_tpu_torch import train as ttrain
from distributed_pytorch_tpu_torch.data import augment as taug
from distributed_pytorch_tpu_torch.data import cifar10 as tcifar
from distributed_pytorch_tpu_torch.data import pipeline as tpipe
from distributed_pytorch_tpu_torch.data import sampler as tsampler
from distributed_pytorch_tpu_torch.utils import metrics as tmetrics

LOSS_FIRST = dict(rtol=1e-5)
LOSS_ALL = dict(rtol=1e-4)
NOISE = 1e-4           # of a tensor's largest entry, one step
AFTER_FIVE = {"params": 1e-3, "state": 1e-4, "momentum": 1e-2}
CFG = dict(model="TINY", strategy="none", batch_size=32, lr=0.02,
           augment=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU shapes: parallel test workers
    each running torch's default thread pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snapshot(jtr):
    return (jax.tree.map(np.array, jtr.params),
            jax.tree.map(np.array, jtr.state),
            jax.tree.map(np.array, jtr.opt_state))


@pytest.fixture(scope="module")
def jax_run():
    """Five JAX steps: the batches, the losses and the state before every
    step (numpy copies: the step donates its buffers)."""
    dl = jpipe.DataLoader(jcifar._synthetic(256, seed=0), 32, shuffle=True,
                          seed=0)
    batches = list(dl)[:5]
    jtr = jtrain.Trainer(jtrain.TrainConfig(**CFG))
    states = [_snapshot(jtr)]
    losses = []
    for b in batches:
        losses.append(float(jtr.train_step(*b)))
        states.append(_snapshot(jtr))
    return batches, losses, states


def _port(states, i=0, momentum=False):
    tr = ttrain.Trainer(ttrain.TrainConfig(**CFG), device="cpu")
    params, state, opt = states[i]
    tr.load_state(*convert.from_jax_vgg(params, state, device="cpu"),
                  momentum=(convert.from_jax_sgd_state(opt, device="cpu")
                            if momentum else None))
    return tr


def _assert_tree_near(got: dict, want: dict, frac: float):
    """Every tensor within ``frac`` of its largest entry, plus 1e-5 (the
    conv biases' gradients are pure rounding noise: BN cancels them)."""
    for k, v in got.items():
        for n, t in v.items():
            ref = want[k][n]
            err = float((t.detach() - ref).abs().max())
            assert err <= frac * float(ref.abs().max()) + 1e-5, (k, n, err)


def _jax_trees(states, i):
    params, state, opt = states[i]
    return (*convert.from_jax_vgg(params, state, device="cpu"),
            convert.from_jax_sgd_state(opt, device="cpu"))


def test_config_fields_match_jax():
    jf = {f.name: f for f in dataclasses.fields(jtrain.TrainConfig)}
    tf = {f.name: f for f in dataclasses.fields(ttrain.TrainConfig)}
    assert list(tf) == list(jf)
    for name in jf:
        assert tf[name].default == jf[name].default, name
    assert ttrain.TrainConfig(compute_dtype="bfloat16").dtype == \
        torch.bfloat16


def test_trainer_matches_jax(jax_run):
    """Five free steps from the JAX initial params: losses, then params, BN
    running state and momentum buffers."""
    batches, want, states = jax_run
    tr = _port(states)
    got = [float(tr.train_step(*b)) for b in batches]
    np.testing.assert_allclose(got[0], want[0], **LOSS_FIRST)
    np.testing.assert_allclose(got, want, **LOSS_ALL)
    for g, w, frac in zip((tr.params, tr.state, tr.momentum()),
                          _jax_trees(states, 5), AFTER_FIVE.values()):
        _assert_tree_near(g, w, frac)
    assert float(tr.last_ok[0]) == 1.0 and tr.last_metrics.shape == (1, 2)
    assert tr._step == 5


@pytest.mark.parametrize("i", range(5))
def test_each_step_from_jax_state(jax_run, i):
    """Step i started from the JAX trainer's state before it (params, BN
    state, the optax momentum trace): its loss and the state after it."""
    batches, want, states = jax_run
    tr = _port(states, i, momentum=True)
    np.testing.assert_allclose(float(tr.train_step(*batches[i])), want[i],
                               **LOSS_FIRST)
    for g, w in zip((tr.params, tr.state, tr.momentum()),
                    _jax_trees(states, i + 1)):
        _assert_tree_near(g, w, NOISE)


def test_continues_from_carried_jax_state(jax_run):
    """The port picks up the JAX run after step 3 (params, BN state and
    the optax momentum trace, carried by convert.py) and reproduces steps
    4 and 5; its momentum goes back into the optax state's structure."""
    batches, want, states = jax_run
    tr = _port(states, 3, momentum=True)
    got = [float(tr.train_step(*b)) for b in batches[3:]]
    np.testing.assert_allclose(got, want[3:], **LOSS_ALL)
    back = convert.to_jax_sgd_state(tr.momentum(), states[5][2])
    assert jax.tree.structure(back) == jax.tree.structure(states[5][2])
    _assert_tree_near(convert.from_jax_sgd_state(back, device="cpu"),
                      _jax_trees(states, 5)[2], AFTER_FIVE["momentum"])


def test_sgd_equals_optax_chain():
    """torch.optim.SGD(lr, momentum, weight_decay) against optax's
    add_decayed_weights + sgd(momentum) over three steps, float32."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3)]
    cfg = ttrain.TrainConfig(strategy="none")
    w = torch.from_numpy(p0.copy()).requires_grad_(True)
    opt = ttrain.make_optimizer(cfg, [w])
    jcfg = jtrain.TrainConfig(strategy="none")
    tx = jtrain.make_optimizer(jcfg)
    params = {"w": p0}
    state = tx.init(params)
    for g in grads:
        w.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update({"w": g}, state, params)
        params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]),
                               rtol=1e-6, atol=1e-7)


def test_steps_per_loop_equals_single_steps():
    """K stacked steps give the trajectory of K single steps, augmentation
    included: its draws depend on (seed, step) only."""
    ds = tcifar._synthetic(32, seed=4)
    images = ds.images.reshape(4, 8, 32, 32, 3)
    labels = ds.labels.reshape(4, 8)
    cfg = ttrain.TrainConfig(model="TINY", strategy="none", batch_size=8,
                             steps_per_loop=4)
    a = ttrain.Trainer(cfg, device="cpu")
    b = ttrain.Trainer(cfg, device="cpu")
    la = a.train_steps(images, labels)
    lb = torch.stack([b.train_step(images[i], labels[i]) for i in range(4)])
    assert torch.equal(la, lb)
    for k in a.params:
        for n in a.params[k]:
            assert torch.equal(a.params[k][n], b.params[k][n])
    assert a._step == b._step == 4
    c = ttrain.Trainer(cfg, device="cpu")
    c.train_step(images[1], labels[1])  # step 0 draws differ from step 1's
    assert not torch.equal(c.params["fc"]["kernel"], b.params["fc"]["kernel"])


# knob -> the sub-slice its refusal names, None: ported (slice 5a: the
# data-parallel strategies, sync-BN, rank 0's buffers, the bucket size;
# dcn_size is read by hierarchical alone, as in the JAX trainer; slice
# 5b-ii: overlap and dcn_compress, each with a strategy that takes it;
# slice 5b-iii: max_sync_every, stored), or "ValueError: ..." (ported, and
# refused in this config with the JAX window check's message: a window
# needs a mesh, an outer optimizer a window)
_KNOB_SLICE = {("strategy", "ddp"): None, ("strategy", "auto"): "5f",
               ("overlap", True): None,
               ("sync_every", 2): "ValueError: sync_every=2 needs a device "
                                  "mesh",
               ("max_sync_every", 4): None,
               ("dcn_compress", "int8"): None,
               ("dcn_size", 4): None,
               ("sync_route", "ici:rs -> dcn:ring -> ici:ag"): "5f",
               ("autotune_profile", "uniform"): "5f", ("sync_bn", True): None,
               ("outer_opt", "nesterov"): "ValueError: outer_opt='nesterov' "
                                          "needs sync_every > 1",
               ("broadcast_buffers", True): None,
               ("overlap_bucket_mb", 4.0): None}
# the strategy a ported knob is tried with (``none`` otherwise)
_KNOB_STRATEGY = {("overlap", True): dict(strategy="ddp"),
                  ("dcn_compress", "int8"): dict(strategy="hierarchical",
                                                 dcn_size=1)}


@pytest.fixture
def no_process_group_after():
    """Destroy the one-rank process group a data-parallel trainer made."""
    yield
    from distributed_pytorch_tpu_torch.parallel import init as pinit
    pinit.shutdown()


@pytest.mark.parametrize("field,value", list(_KNOB_SLICE))
def test_later_slice_knobs_raise(field, value, no_process_group_after):
    """A knob of a later slice raises, naming its sub-slice; a ported knob
    builds a trainer that takes a finite step, or is refused with the JAX
    package's ValueError where the config is incoherent (the JAX trainer
    refuses it alike)."""
    kw = dict(model="TINY", strategy="none", batch_size=4, augment=False)
    kw[field] = value
    kw.update(_KNOB_STRATEGY.get((field, value), {}))
    where = _KNOB_SLICE[(field, value)]
    if where is not None and where.startswith("ValueError: "):
        msg = where[len("ValueError: "):]
        with pytest.raises(ValueError) as e:
            ttrain.Trainer(ttrain.TrainConfig(**kw), device="cpu")
        assert str(e.value).startswith(msg), str(e.value)
        with pytest.raises(ValueError) as je:
            jtrain.Trainer(jtrain.TrainConfig(**kw))
        assert str(je.value) == str(e.value)
        return
    if where is not None:
        with pytest.raises(NotImplementedError, match=f"slice {where}"):
            ttrain.Trainer(ttrain.TrainConfig(**kw), device="cpu")
        return
    tr = ttrain.Trainer(ttrain.TrainConfig(**kw), device="cpu")
    ds = tcifar._synthetic(4, seed=1)
    assert np.isfinite(float(tr.train_step(ds.images, ds.labels)))
    assert float(tr.last_ok[0]) == 1.0 and tr.n_replicas == 1


def test_refusals_and_default_device(no_process_group_after):
    """The default config trains with ddp over a one-rank group; a
    process over several devices is refused (one process a device,
    launch.py); an unknown strategy is a ValueError; without a GPU the
    default device raises."""
    tr = ttrain.Trainer(ttrain.TrainConfig(model="TINY"), device="cpu")
    assert tr.strategy.name == "ddp" and tr.mesh.size() == 1
    assert tr.cfg.broadcast_buffers_resolved
    with pytest.raises(ValueError, match="unknown strategy"):
        ttrain.Trainer(ttrain.TrainConfig(strategy="nope"), device="cpu")
    with pytest.raises(NotImplementedError, match="nproc-per-node 4"):
        ttrain.Trainer(ttrain.TrainConfig(model="TINY", strategy="none"),
                       num_devices=4, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 5c"):
        tr.rebuild()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.Trainer(ttrain.TrainConfig(model="TINY",
                                              strategy="none"))


def test_train_epoch_windows_match_jax_meters():
    """42 iterations: loss windows at 20 and 40, one time window divided by
    39 (the reference's iteration-0 exclusion), as the JAX trainer
    records; the meters reproduce the JAX meters on the same values."""
    ds = tcifar._synthetic(4 * 42, seed=2)
    cfg = ttrain.TrainConfig(model="TINY", batch_size=4, strategy="none",
                             augment=False)
    tr = ttrain.Trainer(cfg, device="cpu")
    lines = []
    lm, tm = tr.train_epoch(tpipe.DataLoader(ds, 4, shuffle=False), epoch=0,
                            log=lines.append)
    assert [(r.first_iter, r.last_iter) for r in lm.records] == \
        [(1, 20), (21, 40)]
    assert [(r.first_iter, r.last_iter) for r in tm.records] == [(2, 40)]
    assert all(np.isfinite(r.value) for r in lm.records)
    assert tm.records[0].value > 0 and len(lines) == 3
    assert lines[0].startswith("Epoch: 1, Iteration: 1-20, Average Loss: ")
    rng = np.random.default_rng(0)
    vals = rng.uniform(0, 3, 85)
    pairs = ((tmetrics.LossMeter(), jmetrics.LossMeter()),
             (tmetrics.IterTimeMeter(), jmetrics.IterTimeMeter()))
    for t, j in pairs:
        for i, v in enumerate(vals):
            assert (t.update(i, float(v)) is None) == \
                (j.update(i, float(v)) is None)
        assert [(r.first_iter, r.last_iter, r.value) for r in t.records] \
            == [(r.first_iter, r.last_iter, r.value) for r in j.records]


# -- data -----------------------------------------------------------------

def test_synthetic_splits_bitwise_equal_jax(tmp_path):
    for n, seed in ((300, 0), (100, 1), (64, 7)):
        t, j = tcifar._synthetic(n, seed), jcifar._synthetic(n, seed)
        assert np.array_equal(t.images, j.images)
        assert np.array_equal(t.labels, j.labels) and t.synthetic
    t = tcifar.load("test", data_dir=str(tmp_path))
    j = jcifar.load("test", data_dir=str(tmp_path))
    assert len(t) == tcifar.TEST_SIZE and t.synthetic
    assert np.array_equal(t.images, j.images)
    assert np.array_equal(t.labels, j.labels)
    assert np.array_equal(tcifar.MEAN, jcifar.MEAN)
    assert np.array_equal(tcifar.STD, jcifar.STD)


@pytest.mark.parametrize("n,replicas,drop_last", [
    (100, 1, False), (101, 4, False), (101, 4, True), (64, 8, False)])
def test_sampler_and_loader_indices_equal_jax(n, replicas, drop_last):
    ds_t, ds_j = tcifar._synthetic(n, 3), jcifar._synthetic(n, 3)
    for rank in range(replicas):
        for shuffle in (True, False):
            t = tsampler.DistributedSampler(n, replicas, rank,
                                            shuffle=shuffle, seed=5,
                                            drop_last=drop_last)
            j = jsampler.DistributedSampler(n, replicas, rank,
                                            shuffle=shuffle, seed=5,
                                            drop_last=drop_last)
            for epoch in (0, 3):
                t.set_epoch(epoch)
                j.set_epoch(epoch)
                assert np.array_equal(t.indices(), j.indices())
                assert len(t) == len(j)
        tl = tpipe.DataLoader(ds_t, 16, sampler=tsampler.DistributedSampler(
            n, replicas, rank, seed=5), drop_last=drop_last)
        jl = jpipe.DataLoader(ds_j, 16, sampler=jsampler.DistributedSampler(
            n, replicas, rank, seed=5), drop_last=drop_last)
        for epoch in (0, 1):
            tl.set_epoch(epoch)
            jl.set_epoch(epoch)
            got, want = list(tl), list(jl)
            assert len(got) == len(want) == len(tl) == len(jl)
            for (ti, tlab), (ji, jlab) in zip(got, want):
                assert np.array_equal(ti, ji) and np.array_equal(tlab, jlab)
    tl = tpipe.DataLoader(ds_t, 32, shuffle=True, seed=2)
    jl = jpipe.DataLoader(ds_j, 32, shuffle=True, seed=2)
    tl.set_epoch(1)
    jl.set_epoch(1)
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(tl, jl))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crop_flip_normalize_bitwise_equal_jax(seed):
    """Given the offsets and flips the JAX ``augment`` draws from its key,
    ``crop_flip_normalize`` returns its output bit for bit, as NCHW in
    channels_last memory format."""
    images = tcifar._synthetic(32, seed + 10).images
    key = jax.random.key(seed)
    want = np.asarray(jaug.augment(key, images))
    ck, fk = jax.random.split(key)
    off = np.array(jax.random.randint(ck, (32, 2), 0, 2 * jaug.PAD + 1))
    flip = np.array(jax.random.bernoulli(fk, shape=(32,)))
    got = taug.crop_flip_normalize(torch.from_numpy(images),
                                   torch.from_numpy(off),
                                   torch.from_numpy(flip))
    assert got.shape == (32, 3, 32, 32)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert np.array_equal(
        taug.normalize(torch.from_numpy(images)).permute(0, 2, 3, 1)
        .numpy(), np.asarray(jaug.normalize(images)))


def test_draws_cover_the_crop_window():
    gen = torch.Generator().manual_seed(3)
    off, flip = taug.draw(gen, 4096, torch.device("cpu"))
    assert off.min() == 0 and off.max() == 2 * taug.PAD
    assert 0.45 < flip.float().mean() < 0.55
    gen.manual_seed(3)
    again, _ = taug.draw(gen, 4096, torch.device("cpu"))
    assert torch.equal(off, again)


def test_prefetch_yields_in_order_and_reraises():
    assert list(tpipe.prefetch(iter(range(10)))) == list(range(10))

    def bad():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(tpipe.prefetch(bad()))


# -- eval and the command line ---------------------------------------------

def test_evaluate_with_ragged_batch_matches_jax():
    """36 samples in batches of 16, 16, 4: the reference's loss (sum of
    per-batch means over the batch count) and accuracy equal the JAX
    package's; ``fold_bn`` gives the same numbers; the printed line is the
    reference's format."""
    jtr = jtrain.Trainer(jtrain.TrainConfig(model="TINY", batch_size=16,
                                            strategy="none"))
    ds = jcifar._synthetic(36, seed=3)
    want = jeval.evaluate(jtr.params, jtr.eval_state(),
                          jpipe.DataLoader(ds, 16), model_name="TINY",
                          log=None)
    params, state = convert.from_jax_vgg(
        jax.tree.map(np.asarray, jtr.params), jtr.eval_state(),
        device="cpu")
    lines = []
    dl = tpipe.DataLoader(tcifar._synthetic(36, seed=3), 16)
    got = teval.evaluate(params, state, dl, model_name="TINY",
                         log=lines.append, device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == want[1]
    folded = teval.evaluate(params, state, dl, model_name="TINY", log=None,
                            fold_bn=True, device="cpu")
    np.testing.assert_allclose(folded[0], got[0], rtol=1e-5)
    assert folded[1] == got[1]
    correct = round(got[1] * 36)
    assert lines == ["Test set: Average loss: {:.4f}, Accuracy: {}/{} "
                     "({:.0f}%)\n".format(got[0], correct, 36,
                                          100.0 * correct / 36)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            teval.evaluate(params, state, dl, model_name="TINY", log=None)


@pytest.fixture
def small_cifar(monkeypatch):
    """The CLI's splits cut to 64 train / 40 test synthetic images."""
    splits = {"train": tcifar._synthetic(64, 0),
              "test": tcifar._synthetic(40, 1)}
    monkeypatch.setattr(tcli, "load", lambda split, data_dir=None:
                        splits[split])


def test_cli_trains_one_tiny_epoch_on_cpu(small_cifar):
    out = tcli.run(["--device", "cpu", "--strategy", "none", "--model",
                    "TINY", "--batch-size", "16", "--epochs", "1"])
    (epoch,) = out["epochs"]
    tr = out["trainer"]
    assert tr._step == 4 and tr.device.type == "cpu" and out["synthetic"]
    loss, acc = epoch["eval"]
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    assert tcli.main(["--device", "cpu", "--strategy", "none", "--model",
                      "TINY", "--batch-size", "32", "--no-augment",
                      "--compute-dtype", "bfloat16",
                      "--fold-bn-eval"]) == 0


def test_cli_needs_the_card_unless_told(small_cifar):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--strategy", "none", "--model", "TINY"])


# argv -> what the command line does: "runs" (slice 5a ported it), the
# sub-slice its refusal names, or the error of a bad rendezvous
_FLAG_OUTCOME = [
    ([], "runs"), (["--strategy", "ddp"], "runs"),
    (["--strategy", "auto"], "5f"), (["--master-ip", "10.0.0.1"], "runs"),
    (["--num-nodes", "2"], "--master-ip is required"),
    (["--rank", "1"], "runs"), (["--rendezvous", "env"], "runs"),
    (["--elastic"], "5c"), (["--checkpoint-dir", "ck"], "runs"),
    (["--max-nodes", "4"], "5c-iii"),
    (["--profile-dir", "p"], "runs"), (["--telemetry-dir", "t"], "runs"),
    (["--shard-eval"], "runs"), (["--debug-checks"], "runs"),
    (["--sync-every", "2"], "usage: sync_every=2 needs a device mesh"),
    (["--overlap", "--strategy", "ddp"], "runs"),
    (["--sync-bn"], "runs"),
    (["--dcn-compress", "int8", "--strategy", "hierarchical", "--dcn-size",
      "1"], "runs"),
    (["--outer-opt", "nesterov"],
     "usage: outer_opt='nesterov' needs sync_every > 1"),
    (["--num-devices", "4"], "nproc-per-node 4"),
    (["--sync-route", "ici:rs"], "5f")]


@pytest.mark.parametrize("argv", [a for a, _ in _FLAG_OUTCOME])
def test_cli_later_slice_flags_raise(small_cifar, argv, capsys, tmp_path,
                                     monkeypatch):
    """A flag of a later slice raises, naming its sub-slice; the window
    flags are ported, and in these configs both CLIs end with the JAX
    window check's usage error (``--strategy none`` has no mesh, and an
    outer optimizer needs a window); the rank
    flags, --shard-eval, --sync-bn, --debug-checks, --overlap (with ddp)
    and --dcn-compress (with hierarchical over 1 x 1) run one epoch (one
    rank: the rendezvous does nothing, as in the JAX package, and the
    default ddp syncs over a one-rank group), and so do --profile-dir (a
    torch.profiler trace of the epoch) and --telemetry-dir (the epoch's
    span and gauges; a run directory relative to the working directory, a
    temporary one here) and --checkpoint-dir (the epoch's checkpoint, which
    a second run resumes past, running no epoch); --elastic and
    --max-nodes name slice 5c-iii; --num-nodes 2 without a
    master is a ValueError, and --num-devices 4 in one process points at
    launch.py."""
    outcome = dict((tuple(a), o) for a, o in _FLAG_OUTCOME)[tuple(argv)]
    base = ["--device", "cpu", "--model", "TINY"]
    if "--strategy" not in argv and argv:
        base += ["--strategy", "none"]
    if outcome == "runs":
        monkeypatch.chdir(tmp_path)
        out = tcli.run(base + argv)
        (epoch,) = out["epochs"]
        assert np.isfinite(epoch["eval"][0])
        assert not torch.distributed.is_initialized()
        if argv[:1] == ["--profile-dir"]:
            (trace,) = os.listdir(tmp_path / "p")
            assert trace.endswith(".pt.trace.json")
        if argv[:1] == ["--checkpoint-dir"]:
            # the epoch's checkpoint; a second run resumes past it
            assert os.listdir(tmp_path / "ck") == ["ckpt_1.npz"]
            again = tcli.run(base + argv)
            assert again["start_epoch"] == 1 and again["epochs"] == []
            assert again["trainer"]._step == out["trainer"]._step
        if argv[:1] == ["--telemetry-dir"]:
            from distributed_pytorch_tpu_torch.utils import telemetry
            assert telemetry.active() is None  # the run closed its own
            s = telemetry.run_summary(str(tmp_path / "t"))
            steps = out["trainer"]._step
            assert s["counters"]["rank0/train/steps"] == steps
            assert s["spans"]["rank0/train/train_steps"]["count"] == steps
            assert s["gauges"]["rank0/train/loss"]["count"] == steps
    elif outcome.startswith("5"):
        with pytest.raises(NotImplementedError, match=f"slice {outcome}"):
            tcli.main(base + argv)
    elif outcome.startswith("usage: "):
        from distributed_pytorch_tpu import cli as jcli
        errs = []
        for main, args in ((tcli.main, base + argv),
                           (jcli.main, base[4:] + argv)):
            with pytest.raises(SystemExit) as e:
                main(args)
            assert e.value.code == 2
            errs.append(capsys.readouterr().err.splitlines()[-1])
        assert outcome[len("usage: "):] in errs[0], errs
        assert errs[0].split("error: ")[1] == errs[1].split("error: ")[1]
    elif outcome.startswith("--master-ip"):
        with pytest.raises(ValueError, match=outcome):
            tcli.main(base + argv)
    else:
        with pytest.raises(NotImplementedError, match=outcome):
            tcli.main(base + argv)
