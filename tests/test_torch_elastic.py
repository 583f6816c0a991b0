"""The port's elastic slice (``launch.py --elastic``, parallel/elastic.py,
``ElasticSampler``, ``resize_mesh``, ``Trainer`` / ``LMTrainer.rebuild``,
``SyncRelaxHook`` and both CLIs' ``--elastic``) against the JAX package's,
on the CPU in float32.

- ``ElasticSampler``: ``global_indices`` and ``indices`` bitwise JAX's over
  a grid of sizes, batches, seeds and memberships (a mid-epoch shrink and a
  grow-back included), and the refusals' messages equal.
- The agent's helpers: the constants, ``heartbeat_verdict`` on a table of
  beacons, each package's ``read_heartbeat`` on the other's ``Heartbeat``
  files, ``ElasticConfig``'s checks and the launch parser's elastic flags
  (defaults and usage errors) equal JAX's.
- The agent: the JAX package's stub-worker programs (tests/test_elastic.py
  and its ``_HB_PRELUDE``, then a start barrier) through both agents side
  by side, telemetry on:
  ``resize_events``, ``drain``, ``restarts_used`` and ``returncode``
  equal, the ``gang_resize``, ``heartbeat_stale`` and ``gang_drain``
  records and the ``elastic_shrink`` postmortem field for field JAX's (a
  stale beat's ``age_s`` is a clock reading: both over the timeout).  A
  port-only case: a survivor that cannot reach its sync point (as one
  blocked in a collective with a dead peer, whose signal handler waits
  for the collective) is SIGKILLed at ``drain_grace``.
- ``resize_mesh``: its rule and messages JAX's, over a (1, 2) mesh in a
  2-rank gang; another size names the drain and re-rendezvous.
- ``SyncRelaxHook``: the same breach and clear sequence through both
  hooks, uniform and per-slice, on stub trainers that record their
  ``rebuild`` calls (one refusing): the calls and the
  ``request_sync_relax`` events equal; then a port ``Trainer`` widened
  and narrowed through a ``RunDoctor``.
- The rebuilds, at world size 1: VGG ``rebuild(sync_every=4)`` of a
  ``ddp`` window and LM ``rebuild(grad_clip=...)`` continue
  bitwise a fresh port trainer at the new config restored from a
  checkpoint taken at the rebuild step, and within rtol 1e-5 (params
  atol 1e-6) of the JAX trainer's ``rebuild`` with the same override.
  The refusals: meshless, strategy change, ``dcn`` extent and pipeline
  with JAX's messages; a change of world size names the drain and
  re-rendezvous (the port's divergence: JAX rebuilds in process).
- In a 2-rank Gloo gang (tests/workers/torch_dp_worker.py ``elastic``): an
  LM window over 2 slices rebuilt from H 2 to 4 mid-window, each rank's
  Adam row slice 0's after it (bitwise), rank 1's poisoned delta dropped,
  the losses bitwise a fresh trainer given the carried state and within
  rtol 1e-5 of the JAX rebuild's; ``dp=2`` rebuilt to ZeRO-3 bitwise a
  fresh ZeRO-3 trainer restored from the per-shard checkpoint; a VGG
  window's momentum and BN statistics rank 0's after its rebuild;
  ``DrainGuard.sync`` true on both ranks when rank 1 alone is signalled.
- The slice end to end: ``launch.py --elastic`` over ``lm_cli --elastic
  --device cpu --checkpoint-sharded``, a ``FAULT_PLAN`` crash of rank 1
  in generation 0 after a periodic checkpoint: the gang shrinks to 1,
  resumes resharded and grows back to 2; the shrunk generation's losses
  bitwise a fresh 1-rank launch restored from the same checkpoint, the
  merged losses within rtol 1e-5 of an uninterrupted 2-rank run, and
  every step's global batch that run's (no window dropped or repeated).
  A standalone ``lm_cli --elastic`` drained by SIGTERM exits 78 with a
  complete checkpoint at the drain step, and its resume is bitwise the
  uninterrupted run.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import launch as jlaunch
from distributed_pytorch_tpu import lm as jlm
from distributed_pytorch_tpu import train as jtrain
from distributed_pytorch_tpu.data import sampler as jsampler
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu.parallel import elastic as jelastic
from distributed_pytorch_tpu.parallel import mesh as jmesh
from distributed_pytorch_tpu.utils import monitor as jmon
from distributed_pytorch_tpu.utils import telemetry as jtel
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import launch as tlaunch
from distributed_pytorch_tpu_torch import lm as tlm
from distributed_pytorch_tpu_torch import train as ttrain
from distributed_pytorch_tpu_torch.data import sampler as tsampler
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from distributed_pytorch_tpu_torch.parallel import elastic as telastic
from distributed_pytorch_tpu_torch.parallel import init as tinit
from distributed_pytorch_tpu_torch.utils import checkpoint as tck
from distributed_pytorch_tpu_torch.utils import monitor as tmon
from distributed_pytorch_tpu_torch.utils import telemetry as ttel
from test_elastic import _HB_PRELUDE
from workers.torch_dp_worker import run_gang, shared_result

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "workers", "torch_dp_worker.py")
LM_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, head_dim=16,
             d_ff=64)


def _quiet(*a):
    pass


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the bitwise checks need the CPU step's sums in
    one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- ElasticSampler -------------------------------------------------------------

@pytest.mark.parametrize("size,batch,seed,shuffle", [
    (50, 8, 3, True), (64, 8, 11, True), (32, 4, 0, False), (7, 3, 5, True)])
def test_sampler_indices_bitwise_jax(size, batch, seed, shuffle):
    """``global_indices`` and every rank's ``indices`` bitwise JAX's for two
    epochs of steps, through a membership that shrinks mid-epoch and grows
    back (over the worlds that divide the batch)."""
    worlds = [w for w in (4, 2, 1, 8, 3) if batch % w == 0]
    membership = [worlds[0]] * 3 + [worlds[-1]] * 2 + [worlds[0]] * 3
    js = jsampler.ElasticSampler(size, batch, seed=seed, shuffle=shuffle)
    ts = tsampler.ElasticSampler(size, batch, seed=seed, shuffle=shuffle)
    assert ts.steps_per_epoch == js.steps_per_epoch
    for step in range(2 * js.steps_per_epoch + 1):
        np.testing.assert_array_equal(ts.global_indices(step),
                                      js.global_indices(step))
        assert ts.epoch_of(step) == js.epoch_of(step)
        world = membership[step % len(membership)]
        for rank in range(world):
            js.set_generation(step, world, rank)
            ts.set_generation(step, world, rank)
            got, want = ts.indices(step), js.indices(step)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_sampler_refusals_and_export_equal_jax():
    from distributed_pytorch_tpu import data as jdata
    from distributed_pytorch_tpu_torch import data as tdata
    assert tdata.ElasticSampler is tsampler.ElasticSampler
    assert jdata.ElasticSampler is jsampler.ElasticSampler
    cases = [lambda m: m.ElasticSampler(0, 8),
             lambda m: m.ElasticSampler(8, -1),
             lambda m: m.ElasticSampler(32, 8).set_generation(1, 3, 0),
             lambda m: m.ElasticSampler(32, 8).set_generation(1, 2, 2)]
    for case in cases:
        msgs = []
        for m in (jsampler, tsampler):
            with pytest.raises(ValueError) as e:
                case(m)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# -- the agent's helpers --------------------------------------------------------

def test_constants_and_env_names_equal_jax():
    names = ("FAULT_EXIT_CODE", "ELASTIC_DRAIN_EXIT_CODE",
             "ELASTIC_RESIZE_EXIT_CODE", "ELASTIC_DIR_ENV", "ELASTIC_MIN_ENV",
             "ELASTIC_MAX_ENV", "HEARTBEAT_PREFIX", "TERM_GRACE_S")
    for n in names:
        assert getattr(tlaunch, n) == getattr(jlaunch, n), n
    for n in names[1:7]:
        assert getattr(telastic, n) == getattr(jelastic, n), n
    assert tlaunch.heartbeat_path("d", 3) == jlaunch.heartbeat_path("d", 3)
    import dataclasses
    assert [(f.name, f.default) for f in dataclasses.fields(
        tlaunch.ElasticConfig)] == [(f.name, f.default) for f in
                                    dataclasses.fields(jlaunch.ElasticConfig)]


def test_heartbeat_verdict_table_equals_jax():
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    table = [
        (None, {}), (None, dict(gen=0)), (None, dict(pid=dead.pid)),
        (None, dict(pid=os.getpid())),
        ({"gen": 0, "age_s": 1.0}, dict(gen=0)),
        ({"gen": 0, "age_s": 9.0}, dict(gen=0)),
        ({"gen": 0, "age_s": 9.0}, dict(gen=1)),
        ({"gen": 0, "age_s": 9.0}, dict(gen=1, pid=dead.pid)),
        ({"gen": 2, "age_s": 0.0}, {}), ({"gen": 2, "age_s": 5.0}, {}),
    ]
    got = [tlaunch.heartbeat_verdict(hb, stale_s=5.0, **kw)
           for hb, kw in table]
    want = [jlaunch.heartbeat_verdict(hb, stale_s=5.0, **kw)
            for hb, kw in table]
    assert got == want
    assert set(got) == {"cold", "lost", "fresh", "stale"}
    assert tlaunch.pid_alive(os.getpid()) and not tlaunch.pid_alive(dead.pid)
    assert not tlaunch.pid_alive(None)


def test_beacons_cross_packages(tmp_path):
    """Each package's reader reads the other's ``Heartbeat`` files (and the
    agents' directory scans); beats are published atomically."""
    telastic.Heartbeat(str(tmp_path), rank=2, generation=1).beat(7)
    jelastic.Heartbeat(str(tmp_path), rank=5, generation=3).beat(9)
    for reader in (tlaunch.read_heartbeat, jlaunch.read_heartbeat):
        a = reader(tlaunch.heartbeat_path(str(tmp_path), 2))
        b = reader(jlaunch.heartbeat_path(str(tmp_path), 5))
        assert (a["rank"], a["step"], a["gen"]) == (2, 7, 1)
        assert (b["rank"], b["step"], b["gen"]) == (5, 9, 3)
        assert 0 <= a["age_s"] < 60 and 0 <= b["age_s"] < 60
    (tmp_path / "hb_rank8.json").write_text('{"rank": 8, "step"')  # torn
    cfg = dict(min_workers=1, max_workers=1)
    got = tlaunch.LocalAgent(["-c", "pass"], log=_quiet, elastic=tlaunch
                             .ElasticConfig(**cfg))._heartbeats(str(tmp_path))
    want = jlaunch.LocalAgent(["-c", "pass"], log=_quiet, elastic=jlaunch
                              .ElasticConfig(**cfg))._heartbeats(
                                  str(tmp_path))
    assert sorted(got) == sorted(want) == [2, 5]
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]
    t = telastic.Heartbeat(str(tmp_path), 0, 0, min_interval_s=60.0)
    t.beat(1)
    t.beat(2)  # rate-limited: the first beat landed, this one does not
    assert tlaunch.read_heartbeat(t.path)["step"] == 1


def test_elastic_config_and_parser_equal_jax(capsys):
    """``ElasticConfig``'s and the multi-node refusals' messages, the
    launch parser's elastic flags and defaults, and ``main``'s usage
    errors equal JAX's."""
    for kw in (dict(min_workers=3, max_workers=2),
               dict(min_workers=0, max_workers=2),
               dict(min_workers=1, max_workers=2, max_resizes=0)):
        msgs = []
        for m in (jlaunch, tlaunch):
            with pytest.raises(ValueError) as e:
                m.ElasticConfig(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    msgs = []
    for m in (jlaunch, tlaunch):
        with pytest.raises(ValueError) as e:
            m.LocalAgent(["-c", "pass"], nnodes=2, elastic=m.ElasticConfig(
                min_workers=1, max_workers=2))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    flags = ["--elastic", "--min-nodes", "--max-nodes", "--heartbeat-timeout",
             "--drain-grace", "--rejoin-delay", "--grow-after-steps",
             "--max-resizes"]
    jp = {o: a for a in jlaunch.build_parser()._actions
          for o in a.option_strings}
    tp = {o: a for a in tlaunch.build_parser()._actions
          for o in a.option_strings}
    for f in flags:
        assert (tp[f].default, tp[f].type, tp[f].dest) == \
            (jp[f].default, jp[f].type, jp[f].dest), f
    argv = ["--elastic", "--min-nodes", "1", "--max-nodes", "4",
            "--heartbeat-timeout", "5", "--drain-grace", "7",
            "--rejoin-delay", "1", "--grow-after-steps", "2",
            "--max-resizes", "3", "--", "-c", "pass"]
    assert vars(tlaunch.build_parser().parse_args(argv)) == \
        vars(jlaunch.build_parser().parse_args(argv))
    for bad in (["--min-nodes", "2"], ["--elastic", "--nnodes", "2"],
                ["--elastic", "--nproc-per-node", "4", "--max-nodes", "8"],
                ["--elastic", "--min-nodes", "3", "--max-nodes", "2"]):
        errs = []
        for m in (jlaunch, tlaunch):
            with pytest.raises(SystemExit) as e:
                m.main(bad + ["--", "-c", "pass"])
            assert e.value.code == 2
            errs.append(capsys.readouterr().err.splitlines()[-1])
        assert errs[0].split("error: ")[1] == errs[1].split("error: ")[1]


# -- the agent on the JAX package's stub programs --------------------------------

STUBS = {
    "shrink_grow": (r"""
for step in range(400):
    beat(step)
    if flag: sys.exit(78)
    if gen == 0 and rank == "1" and step == 3: sys.exit(9)
    if gen >= 2: sys.exit(0)
    time.sleep(0.03)
sys.exit(0)
""", dict(max_workers=3)),
    "hung": (r"""
for step in range(400):
    if gen == 0 and rank == "1" and step >= 3:
        time.sleep(60)  # hung: alive, silent
    beat(step)
    if flag: sys.exit(78)
    if gen >= 1: sys.exit(0)
    time.sleep(0.05)
sys.exit(0)
""", dict(max_workers=2, heartbeat_timeout_s=0.5)),
    "below_min": (r"""
for step in range(400):
    beat(step)
    if flag: sys.exit(78)
    if gen == 0 and rank == "1" and step == 2: sys.exit(5)
    time.sleep(0.03)
""", dict(max_workers=2, min_workers=2)),
    "requested": (r"""
for step in range(400):
    beat(step)
    if flag: sys.exit(78)
    if gen == 0 and rank == "1" and step == 2: sys.exit(79)
    if gen >= 1: sys.exit(0)
    time.sleep(0.03)
sys.exit(0)
""", dict(max_workers=2, grow_after_steps=10_000)),
    "grow_gate": (r"""
if gen == 0:
    beat(0)
    if rank == "2": sys.exit(9)
    while not flag:
        time.sleep(0.02)
    sys.exit(78)
if gen == 1:
    if rank == "1":
        beat(0); beat(1)
        time.sleep(0.2)
        sys.exit(0)
    time.sleep(0.8)
    for step in range(100):
        beat(step)
        if flag: sys.exit(78)
        time.sleep(0.05)
    sys.exit(0)
sys.exit(0)
""", dict(max_workers=3)),
    "budget": (r"""
for step in range(400):
    beat(step)
    if flag: sys.exit(78)
    if rank == "1" and step == 1: sys.exit(9)
    time.sleep(0.03)
sys.exit(0)
""", dict(max_workers=2, grow_after_steps=1, max_resizes=2)),
}
GANG_EVENTS = ("gang_resize", "heartbeat_stale", "gang_drain")
# After the prelude, every rank of a generation waits for the others'
# ready files: a rank SIGTERMed before its interpreter installed the
# prelude's handler would die of the signal instead of draining, and the
# drain counts would follow the machine's load, not the agent.
_READY = r"""
open(os.path.join(d, "ready_%s_%d" % (rank, gen)), "w").close()
while sum(os.path.exists(os.path.join(d, "ready_%d_%d" % (r, gen)))
          for r in range(world)) < world:
    time.sleep(0.005)
"""


def _run_agent(pkg, tel, mon, prog: str, kw: dict, run_dir) -> dict:
    """One agent over a stub program with telemetry on in ``run_dir``: its
    result, its gang events and its ``elastic_shrink`` postmortems."""
    cfg = dict(min_workers=1, heartbeat_timeout_s=60.0, drain_grace_s=10.0,
               rejoin_delay_s=0.0, grow_after_steps=2,
               run_dir=str(run_dir / "hb"))
    cfg.update(kw)
    tel.enable(str(run_dir / "tel"), rank=-1, gen=0, label="agent")
    try:
        agent = pkg.LocalAgent(["-c", _HB_PRELUDE + _READY + prog],
                               nproc_per_node=cfg["max_workers"],
                               monitor_interval_s=0.02,
                               elastic=pkg.ElasticConfig(**cfg), log=_quiet)
        result = agent.run()
    finally:
        tel.disable()
    events = [(r["name"], r["args"]) for _, recs in tel.read_run(
        str(run_dir / "tel")) for r in recs if r.get("name") in GANG_EVENTS]
    bundles = [mon.load_postmortem(p) for p in mon.find_postmortems(
        str(run_dir / "tel"))]
    return {"result": result, "events": events,
            "shrink": [(b["trigger"], b["gang"]) for b in bundles
                       if b["trigger"]["kind"] == "elastic_shrink"]}


@pytest.mark.parametrize("name", list(STUBS))
def test_agent_equals_jax(name, tmp_path):
    """Both agents side by side over one stub program: the result's
    fields, the gang events and the ``elastic_shrink`` postmortems
    equal."""
    prog, kw = STUBS[name]
    out = {}
    runs = [threading.Thread(target=lambda tag=tag, pkg=pkg, tel=tel, mon=mon:
                             out.update({tag: _run_agent(
                                 pkg, tel, mon, prog, kw, tmp_path / tag)}))
            for tag, pkg, tel, mon in (("jax", jlaunch, jtel, jmon),
                                       ("port", tlaunch, ttel, tmon))]
    for t in runs:
        t.start()
    for t in runs:
        t.join(timeout=120)
    j, t = out["jax"], out["port"]
    jr, tr = j["result"], t["result"]
    assert (tr.returncode, tr.failed_rank, tr.restarts_used,
            tr.injected_failures) == (jr.returncode, jr.failed_rank,
                                      jr.restarts_used, jr.injected_failures)
    assert tr.resize_events == jr.resize_events
    assert tr.drain == jr.drain
    for (tn, ta), (jn, ja) in zip(t["events"], j["events"], strict=True):
        assert tn == jn
        if tn == "heartbeat_stale":
            assert ta.pop("age_s") > ta["timeout_s"]
            assert ja.pop("age_s") > ja["timeout_s"]
        assert ta == ja
    assert t["shrink"] == j["shrink"]
    assert len(t["shrink"]) == sum(e["kind"] == "shrink"
                                   for e in tr.resize_events)
    want = {"shrink_grow": [("shrink", 3, 2, "failure"),
                            ("grow", 2, 3, "rejoin")],
            "hung": [("shrink", 2, 1, "heartbeat")],
            "below_min": [], "requested": [("shrink", 2, 1, "requested")],
            "grow_gate": [("shrink", 3, 2, "failure"),
                          ("grow", 2, 3, "rejoin")],
            "budget": [("shrink", 2, 1, "failure"), ("grow", 1, 2, "rejoin"),
                       ("shrink", 2, 1, "failure"),
                       ("grow", 1, 2, "rejoin")]}[name]
    assert [(e["kind"], e["from_size"], e["to_size"], e["reason"])
            for e in tr.resize_events] == want


def test_agent_kills_a_survivor_that_cannot_drain(tmp_path):
    """A survivor whose SIGTERM handler cannot run (as one blocked in a
    collective with a dead peer: a Python handler runs only when the call
    returns) is SIGKILLed at ``drain_grace``, and the gang goes on one
    smaller."""
    prog = r"""
signal.signal(signal.SIGTERM, signal.SIG_IGN) if gen == 0 else None
for step in range(400):
    beat(step)
    if flag: sys.exit(78)
    if gen == 0 and rank == "1" and step == 2: sys.exit(9)
    if gen >= 1: sys.exit(0)
    time.sleep(0.03)
"""
    t0 = time.monotonic()
    r = tlaunch.LocalAgent(
        ["-c", _HB_PRELUDE + _READY + prog], nproc_per_node=2,
        monitor_interval_s=0.02, log=_quiet,
        elastic=tlaunch.ElasticConfig(
            min_workers=1, max_workers=2, drain_grace_s=0.5,
            grow_after_steps=10_000, run_dir=str(tmp_path))).run()
    assert r.returncode == 0 and time.monotonic() - t0 < 30
    assert [(e["kind"], e["to_size"]) for e in r.resize_events] == \
        [("shrink", 1)]
    assert r.drain == {"drained": 0, "exited": 0, "killed": 1}


# -- SyncRelaxHook ---------------------------------------------------------------

class _Cfg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class _StubTrainer:
    """Records ``rebuild`` calls and applies them to its config; refuses
    any target in ``refuse``."""

    def __init__(self, refuse=(), **cfg):
        self.cfg = _Cfg(**cfg)
        self.calls = []
        self.refuse = refuse

    def rebuild(self, **kw):
        self.calls.append(dict(kw))
        if kw.get("sync_every") in self.refuse:
            raise ValueError(f"refused sync_every={kw['sync_every']}")
        self.cfg.__dict__.update(kw)


RELAX = {
    "uniform": (dict(sync_every=2, max_sync_every=16, dcn_size=2,
                     sync_every_per_slice=None), {},
                [("step_time", "b"), ("step_time", "b"), ("other", "b"),
                 ("step_time", "b"), ("step_time", "b"), ("step_time", "c"),
                 ("step_time", "c")]),
    "refused": (dict(sync_every=2, max_sync_every=16, dcn_size=2,
                     sync_every_per_slice=None, refuse=(8,)), {},
                [("step_time", "b"), ("step_time", "b"), ("step_time", "c")]),
    "per_slice": (dict(sync_every=2, max_sync_every=8, dcn_size=3,
                       sync_every_per_slice=None),
                  {"site1": 1, "site2": 2, "site9": 9},
                  [("site1", "b"), ("site1", "b"), ("site2", "b"),
                   ("site1", "b"), ("site9", "b"), ("site1", "c"),
                   ("site2", "c"), ("site2", "c")]),
}


@pytest.mark.parametrize("mode", list(RELAX))
def test_sync_relax_hook_equals_jax(mode, tmp_path):
    cfg, slice_rules, seq = RELAX[mode]
    got = {}
    for tag, mon, tel in (("jax", jmon, jtel), ("port", tmon, ttel)):
        tr = _StubTrainer(**cfg)
        hook = mon.SyncRelaxHook(tr, slice_rules=slice_rules, log=_quiet)
        tel.enable(str(tmp_path / tag), rank=0)
        try:
            for rule, what in seq:
                st = mon.SloState(rule=mon.SloRule(name=rule, metric="m",
                                                   threshold=1.0))
                (hook.breach if what == "b" else hook.clear)(st)
        finally:
            tel.disable()
        events = [r["args"] for _, recs in tel.read_run(str(tmp_path / tag))
                  for r in recs if r.get("name") == "request_sync_relax"]
        got[tag] = (tr.calls, events, dict(tr.cfg.__dict__))
    assert got["port"] == got["jax"]
    assert got["port"][0] and got["port"][1]


def test_sync_relax_hook_drives_a_port_trainer(tmp_path):
    """A step-time breach widens a ``ddp`` window (H 2 -> 4) through the
    trainer's own ``rebuild``, the widened trainer trains, the clear
    narrows it back, and both moves are ``request_sync_relax`` events."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 4, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, (4, 4)).astype(np.int32)
    tel = ttel.enable(str(tmp_path), rank=0)
    doctor = tmon.RunDoctor([tmon.SloRule(
        name="step_time", metric="step_ms", threshold=100.0, op="<=",
        window=4, agg="mean", record="gauge", min_samples=2)])
    try:
        tr = ttrain.Trainer(ttrain.TrainConfig(
            model="TINY", batch_size=4, augment=False, lr=0.01,
            sync_every=2, max_sync_every=4, steps_per_loop=4), device="cpu")
        tmon.SyncRelaxHook(tr).register(doctor)
        assert doctor.attach(tel)
        for _ in range(3):
            tel.gauge("step_ms", 500.0, phase="train")
        assert doctor.states["step_time"].breached
        assert tr.cfg.sync_every == 4
        assert np.isfinite(tr.train_steps(images, labels).numpy()).all()
        for _ in range(6):
            tel.gauge("step_ms", 1.0, phase="train")
        assert not doctor.states["step_time"].breached
        assert tr.cfg.sync_every == 2
        assert np.isfinite(tr.train_steps(images, labels).numpy()).all()
    finally:
        doctor.detach()
        ttel.disable()
        tinit.shutdown()
    relax = ttel.run_summary(str(tmp_path))["events"][
        "rank0/slo/request_sync_relax"]
    assert relax["count"] == 2


# -- the rebuilds at world size 1 -----------------------------------------------

VGG = dict(model="TINY", strategy="ddp", batch_size=8, augment=False,
           lr=0.01, sync_every=2, max_sync_every=4, steps_per_loop=4)


def _vgg_batches():
    """One batch of 8 images every step.  TINY trajectories part between
    the packages on a ReLU flip (tests/test_torch_localsgd.py's
    docstring): with data seed 1 (4 or 16 images) the windowed run parts
    at its third step with no rebuild in it; seeds 2 and 3 at 8 images
    stay within 2e-6 over the 8 steps here."""
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    return np.stack([images] * 4), np.stack([labels] * 4)


def _trace_unchecked(tr) -> None:
    """The JAX windowed ddp step with the replication checker off (this
    JAX does not trace it with the checker on; tests/
    test_torch_localsgd.py)."""
    tr.strategy.vma_opaque = True


def _vflat(tree) -> dict:
    return {f"{k}/{n}": np.asarray(a) for k, v in tree.items()
            for n, a in v.items()}


def _vgg_jax() -> dict:
    from distributed_pytorch_tpu.parallel.mesh import make_mesh
    images, labels = _vgg_batches()
    tr = jtrain.Trainer(jtrain.TrainConfig(**VGG), make_mesh(1))
    _trace_unchecked(tr)
    out = {f"init/p/{k}": v for k, v in _vflat(
        jax.tree.map(np.asarray, tr.params)).items()}
    out.update({f"init/s/{k}": v for k, v in _vflat(tr.eval_state())
                .items()})
    losses = np.asarray(tr.train_steps(images, labels)).tolist()
    tr.rebuild(make_mesh(1), sync_every=4)
    losses += np.asarray(tr.train_steps(images, labels)).tolist()
    out["losses"] = np.asarray(losses)
    out.update({f"p/{k}": v for k, v in _vflat(
        jax.tree.map(np.asarray, tr.params)).items()})
    return out


def _unflat(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            layer, name = k[len(prefix):].split("/")
            out.setdefault(layer, {})[name] = v
    return out


def test_vgg_rebuild_bitwise_fresh_and_near_jax(tmp_path_factory, tmp_path):
    """A ``ddp`` window at world size 1 (H 2, four steps a call) rebuilt to
    H 4: four more steps bitwise a fresh H-4 trainer restored from the
    checkpoint taken at the rebuild, and within the lane's bands of the
    JAX trainer's ``rebuild(sync_every=4)`` from the same start."""
    j = shared_result(tmp_path_factory, "torch_elastic_vgg_jax", _vgg_jax)
    images, labels = _vgg_batches()
    params, state = convert.from_jax_vgg(_unflat(j, "init/p/"),
                                         _unflat(j, "init/s/"), device="cpu")
    try:
        tr = ttrain.Trainer(ttrain.TrainConfig(**VGG), device="cpu")
        tr.load_state(params, state)
        losses = tr.train_steps(images, labels).tolist()
        ck = tck.Checkpointer(str(tmp_path))
        ck.save(tr, 1)
        tr.rebuild(sync_every=4)
        after = tr.train_steps(images, labels)
        fresh = ttrain.Trainer(ttrain.TrainConfig(**dict(VGG, sync_every=4)),
                               device="cpu")
        assert ck.maybe_restore(fresh) == 1 and fresh._step == 4
        assert torch.equal(fresh.train_steps(images, labels), after)
        for k, v in tr.params.items():
            for n, t in v.items():
                assert torch.equal(fresh.params[k][n], t), (k, n)
        np.testing.assert_allclose(losses + after.tolist(), j["losses"],
                                   rtol=1e-5)
        got = convert.to_jax_vgg(tr.params, tr.state)[0]
        for k, v in _vflat(got).items():
            np.testing.assert_allclose(v, j[f"p/{k}"], **LM_TOL, err_msg=k)
    finally:
        tinit.shutdown()


def _lm_batches(n=5, b=4, s=32):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        t = rng.integers(0, 64, (b, s)).astype(np.int32)
        out.append((t, np.roll(t, -1, 1).astype(np.int32)))
    return out


LM_OVERRIDE = dict(grad_clip=0.05)


def _lm_jax() -> dict:
    tr = jlm.LMTrainer(jlm.LMTrainConfig(
        model=jtfm.TransformerConfig(**MODEL), compute_dtype=None))
    out = {f"init/{k}": v.numpy() for k, v in convert.from_jax_params(
        tr.params, device="cpu").items()}
    b = _lm_batches()
    losses = [float(tr.train_step(*x)) for x in b[:2]]
    tr.rebuild(**LM_OVERRIDE)
    losses += [float(tr.train_step(*x)) for x in b[2:]]
    out["losses"] = np.asarray(losses)
    out.update({f"p/{k}": v.numpy() for k, v in convert.from_jax_params(
        tr.params, device="cpu").items()})
    return out


def test_lm_rebuild_bitwise_fresh_and_near_jax(tmp_path_factory, tmp_path):
    """``LMTrainer.rebuild(grad_clip=0.05)`` after two steps (the clip then
    binds):
    three more steps bitwise a fresh trainer at that config restored from
    the checkpoint taken at the rebuild, and within rtol 1e-5 of the JAX
    trainer's ``rebuild`` from the same start."""
    j = shared_result(tmp_path_factory, "torch_elastic_lm_jax", _lm_jax)
    init = {k[5:]: torch.from_numpy(np.array(v)) for k, v in j.items()
            if k.startswith("init/")}
    cfg = tlm.LMTrainConfig(model=ttfm.TransformerConfig(**MODEL),
                            compute_dtype=None)
    b = _lm_batches()
    tr = tlm.LMTrainer(cfg, device="cpu")
    tr.load_state(init)
    losses = [float(tr.train_step(*x)) for x in b[:2]]
    tr.save_checkpoint(str(tmp_path), sharded=True)
    tr.rebuild(**LM_OVERRIDE)
    assert (tr.cfg.grad_clip, tr._step) == (0.05, 2)
    after = [float(tr.train_step(*x)) for x in b[2:]]
    import dataclasses
    fresh = tlm.LMTrainer(dataclasses.replace(cfg, **LM_OVERRIDE),
                          device="cpu")
    assert fresh.maybe_restore(str(tmp_path)) == 2
    assert [float(fresh.train_step(*x)) for x in b[2:]] == after
    np.testing.assert_allclose(losses + after, j["losses"], **LM_TOL)
    for n, p in tr.params.items():
        np.testing.assert_allclose(p.detach().numpy(), j[f"p/{n}"], **LM_TOL,
                                   err_msg=n)


def test_rebuild_refusals(tmp_path):
    """Meshless, strategy change, ``dcn`` extent and pipeline with the JAX
    trainers' messages; a change of world size (``num_devices``, a mesh of
    another size, ``dp``) names the drain and re-rendezvous.  A port
    refusal leaves the config as it was; the JAX VGG trainer commits the
    overrides before its mesh checks, so its refused ``dcn`` extent stays
    in its config (a reference fault, pinned here)."""
    from distributed_pytorch_tpu.parallel.mesh import make_mesh as jmake
    pairs, jax_trainers = [], {}
    base = dict(model="TINY", batch_size=2, augment=False)
    try:
        for kw, call in (
                (dict(strategy="none"), lambda t: t.rebuild()),
                (dict(strategy="ddp"), lambda t: t.rebuild(strategy="none")),
                (dict(strategy="hierarchical", dcn_size=1),
                 lambda t: t.rebuild(mesh=t.mesh, dcn_size=2)),
                (dict(strategy="ddp"),
                 lambda t: t.rebuild(sync_every=2, max_sync_every=2))):
            key = tuple(sorted(kw.items()))
            if key not in jax_trainers:  # reused after a strategy refusal
                jax_trainers[key] = jtrain.Trainer(
                    jtrain.TrainConfig(**base, **kw),
                    None if kw["strategy"] in ("none", "hierarchical")
                    else jmake(1), **({"num_devices": 1} if kw["strategy"]
                                      == "hierarchical" else {}))
            msgs = []
            for t in (jax_trainers[key], ttrain.Trainer(
                    ttrain.TrainConfig(**base, **kw), device="cpu")):
                before = t.cfg
                with pytest.raises(ValueError) as e:
                    call(t)
                msgs.append(str(e.value))
            assert t.cfg == before  # the port's
            pairs.append(msgs)
        jdcn = jax_trainers[(("dcn_size", 1), ("strategy", "hierarchical"))]
        assert jdcn.cfg.dcn_size == 2
        tr = ttrain.Trainer(ttrain.TrainConfig(**base), device="cpu")
        with pytest.raises(NotImplementedError, match="re-rendezvous"):
            tr.rebuild(num_devices=2, sync_every=2, max_sync_every=2,
                       steps_per_loop=2)
        assert tr.cfg == ttrain.TrainConfig(**base)
    finally:
        tinit.shutdown()
    jcfg = jlm.LMTrainConfig(model=jtfm.TransformerConfig(**MODEL),
                             compute_dtype=None)
    msgs = []
    for t in (jlm.LMTrainer(jcfg), tlm.LMTrainer(tlm.LMTrainConfig(
            model=ttfm.TransformerConfig(**MODEL), compute_dtype=None),
            device="cpu")):
        with pytest.raises(ValueError) as e:
            t.rebuild(pp_size=2, microbatches=4, fsdp=False, dp=1)
        msgs.append(str(e.value))
    pairs.append(msgs)
    for j, t in pairs:
        assert t == j
    ltr = tlm.LMTrainer(tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**MODEL), compute_dtype=None),
        device="cpu")
    with pytest.raises(NotImplementedError, match="re-rendezvous"):
        ltr.rebuild(dp=2)
    assert ltr.cfg.dp == 1


def test_reshard_from_checkpoint_restores(tmp_path, monkeypatch):
    """``reshard_from_checkpoint``: the rebuild, then the newest checkpoint
    restored onto the rebuilt layout (the LM trainer's ``maybe_restore``);
    ``drain_exit`` runs the save before it leaves with the drain code, and
    leaves when the save fails too."""
    cfg = tlm.LMTrainConfig(model=ttfm.TransformerConfig(**MODEL),
                            compute_dtype=None)
    tr = tlm.LMTrainer(cfg, device="cpu")
    b = _lm_batches(2)
    tr.train_step(*b[0])
    tr.save_checkpoint(str(tmp_path), sharded=True)
    saved = {n: p.detach().clone() for n, p in tr.params.items()}
    tr.train_step(*b[1])
    assert telastic.reshard_from_checkpoint(tr, str(tmp_path),
                                            grad_clip=0.5) == 1
    assert tr._step == 1 and tr.cfg.grad_clip == 0.5
    assert all(torch.equal(tr.params[n], p) for n, p in saved.items())
    exits, order, lines = [], [], []

    def leave(code):
        exits.append(code)
        raise SystemExit(code)
    monkeypatch.setattr(telastic.os, "_exit", leave)
    with pytest.raises(SystemExit):
        telastic.drain_exit(lambda: order.append("saved"), log=lines.append)
    with pytest.raises(SystemExit):  # a failed save still leaves
        telastic.drain_exit(lambda: 1 / 0, log=lines.append)
    assert exits == [telastic.ELASTIC_DRAIN_EXIT_CODE] * 2
    assert order == ["saved"] and "drain checkpoint failed" in lines[1]
    assert lines[-1] == "[elastic] drained at sync point (exit 78)"


def test_vgg_cli_elastic_beats_and_drains_at_an_epoch(tmp_path, monkeypatch):
    """``cli --elastic`` (64 synthetic images, TINY, ddp over a one-rank
    group): under an agent's ``ELASTIC_DIR`` a beat a dispatch; a SIGTERM
    during epoch 0 drains at the next epoch boundary, saving the epoch-1
    checkpoint, and the drain code is the exit's; a resumed run starts at
    epoch 1.  Without ``--checkpoint-dir``, or under ``--strategy none``,
    the JAX CLI's usage errors."""
    from distributed_pytorch_tpu_torch import cli as tcli
    from distributed_pytorch_tpu_torch.data import cifar10 as tcifar
    splits = {"train": tcifar._synthetic(64, 0),
              "test": tcifar._synthetic(40, 1)}
    monkeypatch.setattr(tcli, "load", lambda split, data_dir=None:
                        splits[split])
    monkeypatch.setenv(tlaunch.ELASTIC_DIR_ENV, str(tmp_path / "hb"))
    monkeypatch.setenv("RESTART_ATTEMPT", "2")
    argv = ["--device", "cpu", "--model", "TINY", "--batch-size", "16",
            "--epochs", "3", "--elastic", "--checkpoint-dir",
            str(tmp_path / "ck")]
    seen, exits = [], []

    def on_step(step):
        seen.append(tlaunch.read_heartbeat(tlaunch.heartbeat_path(
            str(tmp_path / "hb"), 0)))
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    def leave(code):
        exits.append(code)
        raise SystemExit(code)
    monkeypatch.setattr(telastic.os, "_exit", leave)
    try:
        with pytest.raises(SystemExit):
            tcli.run(argv, on_step=on_step)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert exits == [telastic.ELASTIC_DRAIN_EXIT_CODE]
    assert [(b["step"], b["gen"]) for b in seen] == [(s, 2) for s in range(4)]
    assert os.listdir(tmp_path / "ck") == ["ckpt_1.npz"]
    out = tcli.run(argv[:7] + ["1"] + argv[8:])  # --epochs 1: none left
    assert out["start_epoch"] == 1 and out["epochs"] == []
    for bad in (argv[:-2], argv + ["--strategy", "none"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(bad)
        assert e.value.code == 2


# -- a 2-rank gang: the window rebuild, the drain agreement, resize_mesh ----------

WINDOW = dict(dcn_size=2, sync_every=2, max_sync_every=4)


def _gang_inputs() -> dict:
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 64, (7, 4, 32)).astype(np.int32)
    images = rng.integers(0, 256, (4, 4, 32, 32, 3)).astype(np.uint8)
    return {"tokens": tokens,
            "targets": np.roll(tokens, -1, 2).astype(np.int32),
            "images": images,
            "labels": rng.integers(0, 10, (4, 4)).astype(np.int32)}


def _gang_jax(inputs: dict, out: dict) -> None:
    """The JAX trainer's window rebuild on the gang's batches, and its
    ``resize_mesh`` over the same (1, 2) mesh."""
    jtr = jlm.LMTrainer(jlm.LMTrainConfig(
        model=jtfm.TransformerConfig(**MODEL), compute_dtype=None, dp=2,
        **WINDOW))
    losses = [float(jtr.train_step(inputs["tokens"][i],
                                   inputs["targets"][i])) for i in range(3)]
    jtr.rebuild(sync_every=4)
    losses += [float(jtr.train_step(inputs["tokens"][i],
                                    inputs["targets"][i]))
               for i in range(3, 7)]
    out["jax/win/losses"] = np.asarray(losses)
    m = jmesh.make_mesh(2, axis_names=("data", "model"), axis_shape=(1, 2))
    r = jmesh.resize_mesh(m, 2)
    out["jax/mesh/shape"] = np.asarray(r.devices.shape)
    out["jax/mesh/names"] = np.asarray(tuple(r.axis_names))
    try:
        jmesh.resize_mesh(m, 3)
    except ValueError as e:
        out["jax/mesh/3"] = np.asarray(str(e))


def test_gang_rebuilds_drain_and_resize_mesh(tmp_path):
    """2 ranks (tests/workers/torch_dp_worker.py ``elastic``), the JAX
    oracles computed while the gang runs.

    - The LM window, H 2 -> 4 one step into a window: each rank's Adam row
      is slice 0's (rank 0's) after the rebuild, bitwise; rank 1's
      poisoned delta is dropped; the next four losses are bitwise a fresh
      H-4 trainer given the carried state and, with the first three,
      within rtol 1e-5 of the JAX trainer's ``rebuild(sync_every=4)``.
    - ``dp=2`` rebuilt to ZeRO-3: bitwise a fresh ZeRO-3 trainer restored
      from the per-shard checkpoint taken at the rebuild step.
    - The VGG ``ddp`` window rebuilt from H 2 to 4: each rank's momentum
      (each rank's own before) and BN state rank 0's after it.
    - ``DrainGuard.sync``: false, then true on both ranks once rank 1
      alone got SIGTERM.
    - ``resize_mesh`` over a (1, 2) mesh: JAX's shape, names and message;
      another world size names the drain and re-rendezvous."""
    inputs = _gang_inputs()
    jtr = jlm.LMTrainer(jlm.LMTrainConfig(
        model=jtfm.TransformerConfig(**MODEL), compute_dtype=None, dp=2,
        **WINDOW))
    init = convert.from_jax_params(jtr.params, device="cpu")
    del jtr
    inputs.update({f"init/{n}": t.numpy() for n, t in init.items()})
    g, ranks = {}, []
    gang = threading.Thread(target=lambda: ranks.extend(run_gang(
        "elastic", inputs, str(tmp_path / "g"), world=2,
        cases={"model": MODEL, "window": WINDOW,
               "dir": str(tmp_path / "ck")})))
    gang.start()
    _gang_jax(inputs, g)
    gang.join()
    assert len(ranks) == 2
    for r, res in enumerate(ranks):
        g.update({f"r{r}/{k}": v for k, v in res.items()})

    keys = [k[len("r0/win/pre/"):] for k in g if k.startswith("r0/win/pre/")]
    assert keys
    assert any(not np.array_equal(g[f"r0/win/pre/{k}"], g[f"r1/win/pre/{k}"])
               for k in keys)  # the slices' rows had parted
    for r in (0, 1):
        assert int(g[f"r{r}/win/sync_every"]) == 4
        for k in keys:
            np.testing.assert_array_equal(g[f"r{r}/win/post/{k}"],
                                          g[f"r0/win/pre/{k}"], err_msg=k)
        assert np.isfinite(g[f"r{r}/win/losses"]).all()
        np.testing.assert_array_equal(g[f"r{r}/win/fresh"],
                                      g[f"r{r}/win/losses"][3:])
        np.testing.assert_allclose(g[f"r{r}/win/losses"],
                                   g["jax/win/losses"], rtol=1e-5)
        assert int(g[f"r{r}/fsdp/step"]) == 2
        np.testing.assert_array_equal(g[f"r{r}/fsdp/fresh"],
                                      g[f"r{r}/fsdp/losses"])

    vkeys = [k[len("r0/vgg/pre/"):] for k in g
             if k.startswith("r0/vgg/pre/")]
    assert any(k.startswith("m/") for k in vkeys)
    assert any(not np.array_equal(g[f"r0/vgg/pre/{k}"], g[f"r1/vgg/pre/{k}"])
               for k in vkeys if k.startswith("m/"))  # windowed: per rank
    for r in (0, 1):
        assert int(g[f"r{r}/vgg/sync_every"]) == 4
        for k in vkeys:
            np.testing.assert_array_equal(g[f"r{r}/vgg/post/{k}"],
                                          g[f"r0/vgg/pre/{k}"], err_msg=k)
    np.testing.assert_array_equal(g["r0/vgg/after"], g["r1/vgg/after"])

    for r in (0, 1):
        assert not bool(g[f"r{r}/drain/before"])
        assert bool(g[f"r{r}/drain/after"])  # rank 1 alone was signalled
        np.testing.assert_array_equal(g[f"r{r}/mesh/shape"],
                                      g["jax/mesh/shape"])
        assert tuple(g[f"r{r}/mesh/names"]) == tuple(g["jax/mesh/names"])
        assert str(g[f"r{r}/mesh/3"]) == str(g["jax/mesh/3"])
        assert "re-rendezvous" in str(g[f"r{r}/mesh/4"])
    assert not bool(g["r0/drain/local"]) and bool(g["r1/drain/local"])


# -- the slice end to end: launch.py --elastic over lm_cli --elastic ------------

CLI = ["--device", "cpu", "--d-model", "32", "--n-layers", "1", "--n-heads",
       "2", "--head-dim", "16", "--seq-len", "32", "--batch-size", "4",
       "--compute-dtype", "float32", "--log-every", "100"]
GANG_STEPS, CRASH, EVERY = 14, 5, 2


def _corpus(tmp_path) -> str:
    """A 16 KB byte corpus (496 windows of 33 bytes): reading it is
    cheaper than generating the 1 MB synthetic one in every process."""
    path = tmp_path / "corpus.txt"
    if not path.exists():
        path.write_bytes(np.random.default_rng(5).integers(
            0, 256, 16384).astype(np.uint8).tobytes())
    return str(path)


def _env(extra=None) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop(tlaunch.ELASTIC_DIR_ENV, None)
    env.pop("FAULT_PLAN", None)
    env.update(extra or {})
    return env


def _launch(cwd, out, argv, launch=(), env=None, nproc=2):
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "distributed_pytorch_tpu_torch.launch",
           "--nproc-per-node", str(nproc), "--monitor-interval", "0.02",
           "--master-port", str(_free_port()), *launch, "--", WORKER,
           "lm_cli", str(out), *CLI, "--rendezvous", "env", "--corpus",
           _corpus(Path(out).parents[1]), *argv]
    return subprocess.Popen(cmd, cwd=cwd, env=_env(env), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _steps(out) -> dict:
    """{(rank, gen): [records]} of a recorded run."""
    got = {}
    for name in os.listdir(out):
        if name.startswith("steps_r"):
            r, g = name[len("steps_r"):-len(".jsonl")].split("_g")
            with open(os.path.join(out, name)) as f:
                got[(int(r), int(g))] = [json.loads(x) for x in f]
    return got


def _merged(recs: dict) -> dict:
    """step -> (loss, global rows): each step from the newest generation
    that ran it, the ranks' rows in rank order."""
    by_gen: dict = {}
    for (r, g), lines in recs.items():
        for x in lines:
            by_gen.setdefault(x["step"], {}).setdefault(g, {})[r] = x
    out = {}
    for step, gens in by_gen.items():
        ranks = gens[max(gens)]
        out[step] = (float.fromhex(ranks[0]["loss"]),
                     [h for r in sorted(ranks) for h in ranks[r]["rows"]])
    return out


def test_gang_shrink_resume_grow(tmp_path):
    """The slice end to end (2 ranks, Gloo): the crash kills rank 1 at step
    5 of generation 0 (after the step-4 checkpoint); the agent shrinks to
    1, which resumes from step 4 resharded; once it has advanced, the gang
    grows back to 2 through a drain.  Gates: the resize events; the
    shrunk generation's losses bitwise a fresh 1-rank launch from a copy
    of the step-4 checkpoint; the merged losses within rtol 1e-5 of an
    uninterrupted 2-rank run and every step's global batch that run's."""
    common = ["--elastic", "--checkpoint-sharded", "--checkpoint-every",
              str(EVERY), "--steps", str(GANG_STEPS)]
    plan = json.dumps({"kind": "crash", "step": CRASH, "gen": 0, "rank": 1})
    (tmp_path / "e").mkdir()
    (tmp_path / "a").mkdir()
    elastic = _launch(
        tmp_path / "e", tmp_path / "e" / "out",
        common + ["--checkpoint-dir", "ck"],
        launch=("--elastic", "--max-nodes", "2", "--drain-grace", "20",
                "--grow-after-steps", "2", "--telemetry-dir",
                str(tmp_path / "e" / "tel")),
        env={"FAULT_PLAN": plan, "TORCH_ELASTIC_STEP_SLEEP": "0.15"})
    plain = _launch(tmp_path / "a", tmp_path / "a" / "out",
                    common + ["--checkpoint-dir", "ck"])
    # the crash checkpoint, copied once published (later saves prune it)
    src = tmp_path / "e" / "ck" / f"ckpt_{CRASH - 1}"
    dst = tmp_path / "c" / "ck" / f"ckpt_{CRASH - 1}"

    fresh = []

    def copy_when_published():
        while elastic.poll() is None and not (src / "meta.json").exists():
            time.sleep(0.01)
        shutil.copytree(src, dst)
        # a fresh 1-rank launch from it, beside the rest of the run
        fresh.append(_launch(
            tmp_path / "c", tmp_path / "c" / "out",
            ["--elastic", "--checkpoint-sharded", "--checkpoint-dir", "ck",
             "--checkpoint-every", "100", "--steps", str(GANG_STEPS)],
            nproc=1))
    copier = threading.Thread(target=copy_when_published)
    copier.start()
    text, _ = elastic.communicate(timeout=240)
    assert elastic.returncode == 0, text[-4000:]
    ptext, _ = plain.communicate(timeout=240)
    assert plain.returncode == 0, ptext[-4000:]
    assert "resize: gen 0 shrink 2 -> 1 (injected fault)" in text, text[-3000:]
    assert "resize: gen 1 grow 1 -> 2 (rejoin)" in text, text[-3000:]
    recs = _steps(tmp_path / "e" / "out")
    assert sorted(recs) == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 2)]
    shrunk = recs[(0, 1)]
    first, last = shrunk[0]["step"], shrunk[-1]["step"]
    assert first == CRASH  # resumed from the step-4 checkpoint
    assert recs[(0, 2)][0]["step"] == last + 1  # drained at the grow
    # the agent's events: a shrink and a grow, the drains flushed
    runs = {(ep["rank"], ep["gen"]): r
            for ep, r in ttel.read_run(str(tmp_path / "e" / "tel"))}
    resizes = [x["args"] for x in runs[(-1, 0)]
               if x.get("name") == "gang_resize"]
    assert [(x["kind"], x["from_size"], x["to_size"]) for x in resizes] == \
        [("shrink", 2, 1), ("grow", 1, 2)]
    assert tmon.find_postmortems(str(tmp_path / "e" / "tel"))
    # the fresh 1-rank launch from the same checkpoint
    copier.join()
    ftext, _ = fresh[0].communicate(timeout=240)
    assert fresh[0].returncode == 0, ftext[-4000:]
    got = _steps(tmp_path / "c" / "out")[(0, 0)][:len(shrunk)]
    assert [x["step"] for x in got] == [x["step"] for x in shrunk]
    assert [x["loss"] for x in got] == [x["loss"] for x in shrunk]
    # merged over the generations against the uninterrupted run
    merged, whole = _merged(recs), _merged(_steps(tmp_path / "a" / "out"))
    assert sorted(merged) == sorted(whole) == list(range(1, GANG_STEPS + 1))
    for s in whole:
        assert merged[s][1] == whole[s][1], s  # the same global batch
    np.testing.assert_allclose([merged[s][0] for s in sorted(merged)],
                               [whole[s][0] for s in sorted(whole)],
                               rtol=1e-5)


def test_standalone_drain_and_resume(tmp_path):
    """``lm_cli --elastic`` alone, SIGTERM after its third step: exit 78,
    a complete (verified) whole-tree checkpoint at the drain step with the
    loader position, and the resumed run's losses bitwise the
    uninterrupted run's from there."""
    steps = 8

    def child(out, argv, pause="0"):
        os.makedirs(out, exist_ok=True)
        return subprocess.Popen(
            [sys.executable, WORKER, "lm_cli", str(out), *CLI,
             "--corpus", _corpus(tmp_path), "--elastic", "--checkpoint-dir",
             "ck", "--checkpoint-every", "100", *argv], cwd=tmp_path,
            text=True,
            env=_env({"TORCH_ELASTIC_STEP_SLEEP": pause}),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    whole = child(tmp_path / "w", ["--steps", str(steps), "--checkpoint-dir",
                                   "ck_w"])
    p = child(tmp_path / "d", ["--steps", str(steps)], pause="0.2")
    path = tmp_path / "d" / "steps_r0_g0.jsonl"
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if path.exists() and len(path.read_text().splitlines()) >= 3:
            break
        time.sleep(0.02)
    p.send_signal(signal.SIGTERM)
    text, _ = p.communicate(timeout=120)
    assert p.returncode == telastic.ELASTIC_DRAIN_EXIT_CODE, text[-3000:]
    drained = len(path.read_text().splitlines())
    assert 3 <= drained < steps
    flat, meta = tck._load_npz_verified(
        str(tmp_path / "ck" / f"ckpt_{drained}.npz"))
    assert meta["step"] == drained and int(flat["opt/count"]) == drained
    assert meta["loader"]["offset"] == drained
    r = child(tmp_path / "r", ["--steps", str(steps)])
    rtext, _ = r.communicate(timeout=120)
    assert r.returncode == 0, rtext[-3000:]
    wtext, _ = whole.communicate(timeout=120)
    assert whole.returncode == 0, wtext[-3000:]
    want = [x["loss"] for x in _steps(tmp_path / "w")[(0, 0)]]
    got = [x["loss"] for x in _steps(tmp_path / "r")[(0, 0)]]
    assert got == want[drained:]
    assert [x["loss"] for x in _steps(tmp_path / "d")[(0, 0)]] == \
        want[:drained]
