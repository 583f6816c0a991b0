"""The port's fault injection and training sentry
(distributed_pytorch_tpu_torch/utils/faults.py, utils/sentry.py, the
trainers' taps and hooks, the launcher's restart with a resume) against
the JAX package's, on the CPU in float32.

- The ``FaultPlan`` JSON crosses between the packages both ways; the
  generation and rank gates, ``arm_window``'s one-shot firings and the
  ``maybe_delay`` / ``maybe_crash`` windows equal the JAX package's over a
  grid; ``corrupt_file`` writes the JAX package's bytes for each seed and
  mode; the tapped gradient leaf is the one the JAX package taps (its tree
  order), on the LM (dense and MoE) and the VGG trees.
- The sentry on the same plans as the JAX ``TrainingSentry``: the VGG
  trainer through NaN and Inf gradients, the LM trainer through a loss
  spike and a persistent NaN's ladder (with and without a resize hook):
  the skipped batches and every ``stats`` entry but the wall-time
  ``stragglers`` equal, the params within
  the lanes' bands of the JAX trainer's (VGG: 1e-3 of each tensor's
  largest entry, the lane's five-step band; LM: rtol 1e-4 / atol 5e-4),
  and bitwise the port's own clean run without the skipped window.
- Under ``overlap`` the poison lands before the tapped leaf's bucket is
  launched: the step bitwise the post-backward one's.
- ``launch.py`` over ``lm_cli``: an injected crash, a restart and a resume
  from the checkpoint, bitwise an uninterrupted run.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import lm as jlm
from distributed_pytorch_tpu import train as jtrain
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu.utils import faults as jfaults
from distributed_pytorch_tpu.utils import sentry as jsentry
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import launch as tlaunch
from distributed_pytorch_tpu_torch import lm as tlm
from distributed_pytorch_tpu_torch import train as ttrain
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from distributed_pytorch_tpu_torch.parallel import init as tinit
from distributed_pytorch_tpu_torch.utils import faults as tfaults
from distributed_pytorch_tpu_torch.utils import monitor as tmon
from distributed_pytorch_tpu_torch.utils import sentry as tsentry
from distributed_pytorch_tpu_torch.utils import telemetry as ttel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VGG_PARAM_FRAC = 1e-3                      # the VGG lane's five-step band
LM_PARAM_TOL = dict(rtol=1e-4, atol=5e-4)  # the LM lane's params band
LM_SHAPE = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                head_dim=16, d_ff=64)
VGG = dict(model="TINY", strategy="none", batch_size=4, augment=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: bitwise run-to-run checks, and no
    oversubscribed cores under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (tfaults, jfaults):
        f.reset()
    yield
    for f in (tfaults, jfaults):
        f.reset()


def _quiet(*a, **k):
    pass


def _events(stats: dict) -> dict:
    """The sentry's event counts but ``stragglers``: a wall-time reading
    (the JAX trainer's steps recompile after a clip tightening, the port's
    do not), not an outcome of the plan."""
    return {k: v for k, v in stats.items() if k != "stragglers"}


def _install(plan: tfaults.FaultPlan) -> None:
    """The same plan in both packages."""
    tfaults.install(plan)
    jfaults.install(jfaults.FaultPlan(**json.loads(plan.to_env())))


# -- plans, gates, windows ------------------------------------------------------

def test_names_defaults_and_plan_json_match_jax():
    assert tfaults.KINDS == jfaults.KINDS
    assert tfaults.RPC_KINDS == jfaults.RPC_KINDS
    assert tfaults.FAULT_EXIT_CODE == jfaults.FAULT_EXIT_CODE \
        == tlaunch.FAULT_EXIT_CODE
    assert tfaults.ENV_VAR == jfaults.ENV_VAR
    for mod_t, mod_j in ((tfaults, jfaults), (tsentry, jsentry)):
        for name, obj in vars(mod_j).items():
            if name.startswith("_") or not callable(obj) or \
                    getattr(obj, "__module__", None) != mod_j.__name__:
                continue
            mine = getattr(mod_t, name)
            want = inspect.signature(obj).parameters
            got = inspect.signature(mine).parameters
            for p, v in want.items():
                assert got[p].default == v.default, (name, p)
    for cls_t, cls_j in ((tfaults.FaultPlan, jfaults.FaultPlan),
                         (tsentry.SentryConfig, jsentry.SentryConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(cls_t)] == \
            [(f.name, f.default) for f in dataclasses.fields(cls_j)]
    plan = tfaults.FaultPlan(kind="rpc_torn", step=5, seed=2, gen=1, rank=3,
                             magnitude=7.0, delay_s=0.5, count=4,
                             mode="crc", op="poll")
    assert dataclasses.asdict(jfaults.FaultPlan(
        **json.loads(plan.to_env()))) == dataclasses.asdict(plan)
    back = jfaults.FaultPlan(kind="straggler", step=9, delay_s=0.1)
    assert dataclasses.asdict(tfaults.FaultPlan(
        **json.loads(back.to_env()))) == dataclasses.asdict(back)
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.FaultPlan(kind="meteor")


def test_env_plan_and_gates_equal_jax(monkeypatch):
    """``FAULT_PLAN`` from the environment, gated by generation
    (``RESTART_ATTEMPT``) and rank (``RANK`` outside a process group), over
    a grid: ``armed`` agrees with the JAX package's everywhere."""
    for gen in (-1, 0, 1):
        for rank in (-1, 0, 1):
            plan = tfaults.FaultPlan(kind="crash", step=3, gen=gen,
                                     rank=rank)
            monkeypatch.setenv(tfaults.ENV_VAR, plan.to_env())
            for attempt in ("0", "1"):
                for env_rank in ("0", "1"):
                    monkeypatch.setenv("RESTART_ATTEMPT", attempt)
                    monkeypatch.setenv("RANK", env_rank)
                    tfaults.reset()
                    jfaults.reset()
                    assert tfaults.get_plan() == plan
                    got = tfaults.armed("crash") is not None
                    assert got == (jfaults.armed("crash") is not None), \
                        (gen, rank, attempt, env_rank)
                    assert tfaults.armed("nan_grad") is None


def test_arm_window_and_host_windows_equal_jax(monkeypatch):
    """``arm_window``'s firings over call sequences, and the dispatch
    windows ``maybe_delay`` sleeps in and ``maybe_crash`` exits in, equal
    the JAX package's for each (plan step, count) and window size."""
    calls = [(s, k) for s in range(0, 12, 1) for k in (1, 3)] * 2
    for step in (0, 4, 7):
        for count in (1, 2, 3):
            _install(tfaults.FaultPlan(kind="nan_grad", step=step,
                                       count=count))
            got = [tfaults.arm_window(s, k) for s, k in calls]
            want = [jfaults.arm_window(s, k) for s, k in calls]
            assert got == want and sum(got) == count
            tfaults.reset()
            jfaults.reset()
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)

    class Exit(Exception):
        pass

    def fake_exit(code):
        raise Exit(code)
    monkeypatch.setattr(os, "_exit", fake_exit)
    for kind in ("straggler", "crash"):
        for step in (2, 5):
            _install(tfaults.FaultPlan(kind=kind, step=step, count=2,
                                       delay_s=0.25))
            for window in (1, 2, 4):
                hits = []
                for mod in (tfaults, jfaults):
                    fired = []
                    for s in range(0, 10):
                        slept.clear()
                        try:
                            (mod.maybe_delay if kind == "straggler"
                             else mod.maybe_crash)(s, window)
                            fired.append(bool(slept))
                        except Exit as e:
                            assert e.args == (77,)
                            fired.append(True)
                    hits.append(fired)
                assert hits[0] == hits[1] and any(hits[0]), (kind, step)
            tfaults.reset()
            jfaults.reset()


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_corrupt_file_bytes_equal_jax(tmp_path, mode):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 4000).astype(np.uint8).tobytes()
    for seed in range(5):
        paths = [tmp_path / f"{seed}_{p}" for p in ("t", "j")]
        for p in paths:
            p.write_bytes(data)
        tfaults.corrupt_file(str(paths[0]), mode=mode, seed=seed)
        jfaults.corrupt_file(str(paths[1]), mode=mode, seed=seed)
        assert paths[0].read_bytes() == paths[1].read_bytes() != data


def _jax_tapped(tree, plan) -> str:
    """The JAX package's tapped leaf: its path, '/'-joined."""
    _install(plan)
    out = jfaults.tap_grads(jax.tree.map(jnp.asarray, tree),
                            jnp.int32(plan.step), jnp.float32(1.0))
    hit = [p for p, v in jax.tree_util.tree_flatten_with_path(out)[0]
           if not np.all(np.isfinite(np.asarray(v)))]
    assert len(hit) == 1
    return "/".join(k.key for k in hit[0])


def _port_tapped(names, leaves, plan) -> str:
    tfaults.install(plan)
    assert tfaults.tap_grads(leaves, plan.step + 1, 1.0) is leaves
    assert tfaults.tap_grads(leaves, plan.step, 0.0) is leaves
    out = tfaults.tap_grads(leaves, plan.step, 1.0)
    hit = [n for n, t, s in zip(names, out, leaves) if t is not s]
    assert len(hit) == 1
    i = names.index(hit[0])
    assert not bool(torch.isfinite(out[i]).any())
    return hit[0]


@pytest.mark.parametrize("model", ["lm", "lm_moe", "vgg"])
def test_tapped_leaf_is_jax(model):
    """For every seed the port poisons the leaf the JAX package poisons:
    leaf ``seed % n`` of the JAX tree order."""
    if model == "vgg":
        params, _ = ttrain.vgg.init(0, "TINY", device="cpu")
        names = ["/".join(kn) for kn in ttrain.jax_order(params)]
        leaves = [torch.zeros_like(params[k][n])
                  for k, n in ttrain.jax_order(params)]
        tree, _ = convert.to_jax_vgg(params, {})
    else:
        extra = dict(n_layers=2, n_experts=2) if model == "lm_moe" else {}
        cfg = ttfm.TransformerConfig(**dict(LM_SHAPE, **extra))
        shapes = tlm.param_shapes(cfg)
        order = tlm.jax_order(shapes)
        names = ["/".join(tlm.jax_path(n)) for n in order]
        leaves = [torch.zeros(shapes[n]) for n in order]
        tree = convert.to_jax_params({n: torch.zeros(shapes[n])
                                      for n in shapes})
    for seed in range(len(leaves) + 3):
        for kind in ("nan_grad", "inf_grad"):
            plan = tfaults.FaultPlan(kind=kind, step=3, seed=seed)
            assert _port_tapped(names, leaves, plan) == \
                _jax_tapped(tree, plan), (seed, kind)
            tfaults.reset()
            jfaults.reset()


def test_tap_loss_and_no_plan_launch_nothing():
    loss = torch.tensor(2.5)
    assert tfaults.tap_loss(loss, 3, 1.0) is loss
    tfaults.install(tfaults.FaultPlan(kind="loss_spike", step=3,
                                      magnitude=1e6))
    assert tfaults.tap_loss(loss, 2, 1.0) is loss
    assert tfaults.tap_loss(loss, 3, 0.0) is loss
    assert float(tfaults.tap_loss(loss, 3, 1.0)) == 2.5e6
    assert tfaults.grad_tap(3, 1.0) is None  # a loss plan taps no grad


def test_rendezvous_flap_and_exhaustion():
    """The port's dial loop consults the rendezvous plan: two refusals
    then a connection, or a ``RendezvousError`` naming the coordinator."""
    tfaults.install(tfaults.FaultPlan(kind="rendezvous", count=2))
    calls = []
    tinit.init_distributed("127.0.0.1", num_nodes=2, rank=0,
                           backoff_base_s=0.001, device="cpu",
                           _initialize=lambda **kw: calls.append(kw))
    assert len(calls) == 1
    assert calls[0]["init_method"] == "tcp://127.0.0.1:6585"
    tfaults.reset()
    tfaults.install(tfaults.FaultPlan(kind="rendezvous", count=99))
    calls.clear()
    with pytest.raises(tinit.RendezvousError) as e:
        tinit.init_distributed("10.0.0.9", num_nodes=4, rank=2,
                               connect_attempts=3, backoff_base_s=0.001,
                               device="cpu",
                               _initialize=lambda **kw: calls.append(kw))
    assert not calls
    msg = str(e.value)
    assert "10.0.0.9" in msg and "rank 2/4" in msg and "3 attempts" in msg


# -- the sentry against the JAX package's -------------------------------------

def _vgg_batches(n, bs=4):
    rng = np.random.default_rng(1234)
    return [(rng.integers(0, 256, (bs, 32, 32, 3)).astype(np.uint8),
             rng.integers(0, 10, bs).astype(np.int32)) for _ in range(n)]


def _near_vgg(got: dict, want: dict):
    for k, v in got.items():
        for n, t in v.items():
            ref = want[k][n]
            err = float((t.detach() - ref).abs().max())
            assert err <= VGG_PARAM_FRAC * float(ref.abs().max()) + 1e-5, \
                (k, n, err)


@pytest.mark.parametrize("kind", ["nan_grad", "inf_grad"])
def test_vgg_sentry_rollback_matches_jax(kind):
    """A NaN/Inf gradient at step 4 on both trainers: the same skipped
    batch and stats, params within the band of the JAX trainer's, and
    bitwise the port's clean run without batch 4."""
    batches = _vgg_batches(8)
    plan = tfaults.FaultPlan(kind=kind, step=4, seed=3)
    _install(plan)
    jtr = jtrain.Trainer(jtrain.TrainConfig(**VGG))
    p0, s0 = (jax.tree.map(np.array, t) for t in (jtr.params, jtr.state))
    tr = ttrain.Trainer(ttrain.TrainConfig(**VGG), device="cpu")
    tr.load_state(*convert.from_jax_vgg(p0, s0, device="cpu"))
    runs = []
    for t, mod in ((jtr, jsentry), (tr, tsentry)):
        s = mod.TrainingSentry(t, mod.SentryConfig(checkpoint_every=2),
                               log=_quiet)
        runs.append(([i for i, b in enumerate(batches)
                      if s.step(*b) is None], _events(s.stats)))
    assert runs[0] == runs[1]
    assert runs[1][0] == [4] and runs[1][1]["nonfinite"] == 1
    assert tr._step == jtr._step == 7
    want, _ = convert.from_jax_vgg(jax.tree.map(np.array, jtr.params), s0,
                                   device="cpu")
    _near_vgg(tr.params, want)
    tfaults.reset()
    clean = ttrain.Trainer(ttrain.TrainConfig(**VGG), device="cpu")
    clean.load_state(*convert.from_jax_vgg(p0, s0, device="cpu"))
    for i, b in enumerate(batches):
        if i != 4:
            clean.train_step(*b)
    for tree, mine in ((clean.params, tr.params), (clean.state, tr.state),
                       (clean.momentum(), tr.momentum())):
        for k, v in tree.items():
            for n, t in v.items():
                assert torch.equal(mine[k][n], t), (k, n)


def _lm_batches(n, bs=2, s=32, vocab=64):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (bs, s)).astype(np.int32)
        out.append((t, np.roll(t, -1, 1)))
    return out


def _lm_pair():
    """The JAX LM trainer and the port's from its initial params."""
    jtr = jlm.LMTrainer(jlm.LMTrainConfig(
        model=jtfm.TransformerConfig(**LM_SHAPE), compute_dtype=None))
    p0 = jax.tree.map(np.array, jtr.params)
    tr = tlm.LMTrainer(tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**LM_SHAPE), compute_dtype=None),
        device="cpu")
    tr.load_state(convert.from_jax_params(p0, device="cpu"))
    return jtr, tr, p0


def _near_lm(tr, jtr):
    want = convert.from_jax_params(jax.tree.map(np.array, jtr.params),
                                   device="cpu")
    for n, p in tr.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   **LM_PARAM_TOL, err_msg=n)


def test_lm_sentry_spike_matches_jax():
    """A 1e6 loss spike at step 5: rollback to the step-4 snapshot and
    the window (batches 4 and 5) skipped, as the JAX sentry does; the
    params within the LM band of the JAX trainer's and bitwise the
    port's clean run without batches 4 and 5."""
    batches = _lm_batches(9)
    _install(tfaults.FaultPlan(kind="loss_spike", step=5, magnitude=1e6))
    jtr, tr, p0 = _lm_pair()
    cfg = dict(checkpoint_every=2, spike_window=8, spike_threshold=8.0,
               spike_min_history=3)
    runs = []
    for t, mod in ((jtr, jsentry), (tr, tsentry)):
        s = mod.TrainingSentry(t, mod.SentryConfig(**cfg), log=_quiet)
        runs.append(([i for i, b in enumerate(batches)
                      if s.step(*b) is None], _events(s.stats)))
    assert runs[0] == runs[1] and runs[1][0] == [5]
    assert runs[1][1]["skipped_steps"] == 2
    _near_lm(tr, jtr)
    tfaults.reset()
    clean = tlm.LMTrainer(tr.cfg, device="cpu")
    clean.load_state(convert.from_jax_params(p0, device="cpu"))
    for i, b in enumerate(batches):
        if i not in (4, 5):
            clean.train_step(*b)
    assert clean._step == tr._step
    for n, p in clean.params.items():
        assert torch.equal(tr.params[n], p), n


@pytest.mark.parametrize("resize", [False, True])
def test_lm_sentry_ladder_matches_jax(resize, tmp_path):
    """A persistent NaN (``count`` 99) climbs the ladder: skip, tighten
    the clip twice, then (with an in-process resize hook) one resize and a
    fresh horizon, then abort with a ``sentry_abort`` postmortem; the
    stats, the clip and the hook's calls equal the JAX sentry's."""
    _install(tfaults.FaultPlan(kind="nan_grad", step=2, count=99))
    jtr, tr, _ = _lm_pair()
    batch = _lm_batches(1)[0]
    out = []
    ttel.enable(str(tmp_path), rank=0)
    try:
        for t, mod in ((jtr, jsentry), (tr, tsentry)):
            hooks = []
            s = mod.TrainingSentry(
                t, mod.SentryConfig(checkpoint_every=100, skip_budget=1,
                                    max_rollbacks=3),
                on_resize=(lambda st, h=hooks: h.append(st) or True)
                if resize else None, log=_quiet)
            with pytest.raises(mod.SentryAbort) as e:
                for _ in range(60):
                    s.step(*batch)
            out.append((_events(e.value.stats), t.cfg.grad_clip,
                        [h["rollbacks"] for h in hooks]))
    finally:
        ttel.disable()
    assert out[0] == out[1]
    stats = out[1][0]
    assert stats["resizes"] == int(resize) and stats["clip_tightened"] >= 2
    (bundle,) = tmon.find_postmortems(str(tmp_path))
    b = tmon.load_postmortem(bundle)
    assert b["trigger"]["kind"] == "sentry_abort"
    assert b["trigger"]["stats"]["nonfinite"] == stats["nonfinite"]


def test_sentry_fractional_flag_straggler_and_breach_hook():
    """A fractional health flag (one replica of eight poisoned) is a bad
    step; a straggler is counted and never rolled back; the breach hook
    turns a breach at or above its severity into the resize rung."""
    class Fake:
        _step = 0
        params = {"w": torch.zeros(2)}

        def train_step(self, loss):
            self._step += 1
            self.last_ok = torch.tensor(0.875)
            return torch.tensor(loss)
    s = tsentry.TrainingSentry(Fake(), tsentry.SentryConfig(max_rollbacks=5),
                               log=_quiet)
    assert s.step(1.0) is None and s.stats["nonfinite"] == 1

    tfaults.install(tfaults.FaultPlan(kind="straggler", step=10,
                                      delay_s=0.25, count=1))
    tr = ttrain.Trainer(ttrain.TrainConfig(**VGG), device="cpu")
    s = tsentry.TrainingSentry(tr, tsentry.SentryConfig(checkpoint_every=100),
                               log=_quiet)
    batch = _vgg_batches(1)[0]
    assert all(s.step(*batch) is not None for _ in range(13))
    assert s.stats["rollbacks"] == 0 and s.stats["stragglers"] >= 1

    reasons = []
    fake = types.SimpleNamespace(request_resize=reasons.append)
    hook = tmon.sentry_breach_hook(fake)
    for sev in ("info", "warn", "critical"):
        hook(types.SimpleNamespace(rule=types.SimpleNamespace(
            severity=sev, name=f"r_{sev}")))
    assert reasons == ["slo:r_critical"]
    tmon.sentry_breach_hook(fake, severity="warn")(types.SimpleNamespace(
        rule=types.SimpleNamespace(severity="warn", name="w")))
    assert reasons[-1] == "slo:w"


def test_vgg_overlap_poisons_before_the_bucket_launch():
    """Under ``overlap`` (ddp over a one-rank group) the tapped leaf's
    cotangent is poisoned before its bucket's sync: the health flag drops
    at the fired step and the params equal the post-backward run's (NaN
    in the same places, the rest bitwise)."""
    try:
        got = []
        for overlap in (False, True):
            tfaults.reset()
            tfaults.install(tfaults.FaultPlan(kind="nan_grad", step=1,
                                              seed=5))
            tr = ttrain.Trainer(ttrain.TrainConfig(
                model="TINY", strategy="ddp", overlap=overlap,
                batch_size=4, augment=False), device="cpu")
            batch = _vgg_batches(1)[0]
            oks = []
            for _ in range(2):
                tr.train_step(*batch)
                oks.append(float(tr.last_ok[0]))
            assert oks == [1.0, 0.0]
            got.append({f"{k}/{n}": t.detach().clone()
                        for k, v in tr.params.items() for n, t in v.items()})
        bad = [k for k, t in got[0].items() if not torch.isfinite(t).all()]
        assert len(bad) >= 1
        for k, t in got[0].items():
            assert torch.equal(torch.nan_to_num(t, nan=7.0),
                               torch.nan_to_num(got[1][k], nan=7.0)), k
    finally:
        tinit.shutdown()


# -- the launcher: crash, restart, resume ----------------------------------------

def test_launch_crash_restart_resume_bitwise(tmp_path):
    """``launch.py --max-restarts 1`` over ``lm_cli --checkpoint-dir``:
    the ``FAULT_PLAN`` crash at step 5 kills generation 0 (exit 77, an
    injected fault), generation 1 resumes from the step-4 checkpoint and
    its loader position, and the final checkpoint's params and Adam state
    are bitwise an uninterrupted run's."""
    def run(name, env):
        d = tmp_path / name
        d.mkdir()
        cmd = [sys.executable, "-m", "distributed_pytorch_tpu_torch.launch",
               "--max-restarts", "1", "--monitor-interval", "0.05", "--",
               "-m", "distributed_pytorch_tpu_torch.lm_cli", "--device",
               "cpu", "--d-model", "32", "--n-layers", "1", "--n-heads", "2",
               "--head-dim", "16", "--seq-len", "32", "--batch-size", "2",
               "--compute-dtype", "float32", "--log-every", "1", "--steps",
               "8", "--checkpoint-dir", "ck", "--checkpoint-every", "2"]
        p = subprocess.run(cmd, cwd=d, capture_output=True, text=True,
                           timeout=300, env=dict(
                               os.environ, OMP_NUM_THREADS="1",
                               PYTHONPATH=REPO + os.pathsep
                               + os.environ.get("PYTHONPATH", ""), **env))
        assert p.returncode == 0, (p.stdout[-3000:], p.stderr[-3000:])
        return p.stdout + p.stderr, d / "ck"
    plan = tfaults.FaultPlan(kind="crash", step=5, gen=0)
    text, ck = run("crashed", {tfaults.ENV_VAR: plan.to_env()})
    assert "injected crash at step 5" in text
    assert text.count("(injected fault)") == 1
    assert "resumed at step 4" in text
    text0, ck0 = run("clean", {})
    assert "(injected fault)" not in text0
    from distributed_pytorch_tpu_torch.utils import checkpoint as tck
    a, ma = tck._load_npz_verified(str(ck / "ckpt_8.npz"))
    b, mb = tck._load_npz_verified(str(ck0 / "ckpt_8.npz"))
    assert ma["loader"] == mb["loader"] and set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_reference_window_rollback_keeps_the_poisoned_delta():
    """A fault of the reference, which the port shares: the sentry's
    snapshot holds params, opt_state and sync_state, not a sync window's
    delta, so a transient NaN inside a window (dp=2 over 2 slices,
    sync_every=2, the NaN at the window's first step) is rolled back with
    the poisoned delta kept, every later step is non-finite, and the
    ladder aborts.  The port's snapshot is the same set (``_STATE_ATTRS``;
    the port's ``_delta`` is no attribute it reads)."""
    assert tsentry._STATE_ATTRS == jsentry._STATE_ATTRS
    jfaults.install(jfaults.FaultPlan(kind="nan_grad", step=2))
    jtr = jlm.LMTrainer(jlm.LMTrainConfig(
        model=jtfm.TransformerConfig(**LM_SHAPE), compute_dtype=None, dp=2,
        dcn_size=2, sync_every=2))
    s = jsentry.TrainingSentry(jtr, jsentry.SentryConfig(checkpoint_every=2),
                               log=_quiet)
    rng = np.random.default_rng(0)
    with pytest.raises(jsentry.SentryAbort) as e:
        for _ in range(12):
            t = rng.integers(0, 64, (2, 32)).astype(np.int32)
            s.step(t, np.roll(t, -1, 1))
    assert not all(bool(np.all(np.isfinite(np.asarray(x))))
                   for x in jax.tree.leaves(jtr._delta))
    assert (e.value.stats["steps"], e.value.stats["nonfinite"],
            e.value.stats["rollbacks"]) == (2, 4, 3)
