"""The port's run doctor (distributed_pytorch_tpu_torch/utils/monitor.py)
and its two scripts (scripts/torch_telemetry_summary.py,
scripts/torch_postmortem.py) against the JAX package's, on the CPU.

The SLO rules, the doctor's transitions and events on one seeded record
stream (the clock pinned for both), the offline ``evaluate_run``, the
postmortem bundles and their rendering are the JAX package's; the memory
lane reads ``torch.cuda.memory_stats`` where JAX reads
``Device.memory_stats``, so it is held to its own definition (and, on the
card, to ``torch.cuda.max_memory_allocated``, chip_smoke.py phase 23).
"""

import contextlib
import io
import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.utils import monitor as jmon
from distributed_pytorch_tpu.utils import telemetry as jtel
from distributed_pytorch_tpu_torch.utils import monitor as tmon
from distributed_pytorch_tpu_torch.utils import telemetry as ttel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCKS = ("ts", "dur", "wall", "mono", "pid", "host")
PACKAGES = ((jmon, jtel), (tmon, ttel))


@pytest.fixture(autouse=True)
def _clean_registries():
    jtel.disable()
    ttel.disable()
    yield
    jtel.disable()
    ttel.disable()


def _records(run_dir):
    out = []
    for name in sorted(os.listdir(run_dir)):
        if name.startswith("events_"):
            with open(os.path.join(run_dir, name)) as f:
                out.append([{k: v for k, v in json.loads(line).items()
                             if k not in CLOCKS} for line in f])
    return out


def _scripts():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import postmortem
        import telemetry_summary
        import torch_postmortem
        import torch_telemetry_summary
    finally:
        sys.path.pop(0)
    return {"summary": (telemetry_summary, torch_telemetry_summary),
            "postmortem": (postmortem, torch_postmortem)}


BAD_RULES = [dict(op="=="), dict(agg="median"), dict(severity="meh"),
             dict(record="metric"), dict(window=0)]


@pytest.mark.parametrize("bad", BAD_RULES,
                         ids=[next(iter(b)) for b in BAD_RULES])
def test_slo_rule_refusals_equal_jax(bad):
    msgs = []
    for mon, _ in PACKAGES:
        with pytest.raises(ValueError) as e:
            mon.SloRule(name="r", metric="m", threshold=1.0, **bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_slo_rule_dicts_matching_and_values_equal_jax():
    kw = dict(name="r", metric="step", threshold=1.0, op=">=",
              agg="mean", record="span", severity="critical", rank=1,
              phase="train", window=7)
    j, t = jmon.SloRule(**kw), tmon.SloRule(**kw)
    assert t.to_dict() == j.to_dict()
    d = dict(t.to_dict(), future_field=1)  # unknown keys are dropped
    assert tmon.SloRule.from_dict(d) == t
    assert tmon.SloRule.from_dict(j.to_dict()).to_dict() == j.to_dict()
    rec = {"type": "span", "name": "step", "phase": "train", "rank": 1,
           "dur": 0.25}
    cases = [rec, {**rec, "type": "hist"}, {**rec, "rank": 0},
             {**rec, "phase": "serve"}, {**rec, "name": "x"}]
    assert [t.matches(r) for r in cases] == [j.matches(r) for r in cases]
    assert t.value_of(rec) == j.value_of(rec) == 250.0
    for record, r in (("gauge", {"value": 2}), ("gauge", {"value": "NaN"}),
                      ("counter", {"inc": 3}), ("event", {}),
                      ("hist", {"value": 0.5})):
        kw2 = dict(name="g", metric="m", threshold=1.0, record=record)
        assert tmon.SloRule(**kw2).value_of(r) == \
            jmon.SloRule(**kw2).value_of(r)


def _stream(seed: int = 7) -> list[dict]:
    """A seeded run: step spans that slow down and recover, a loss with
    spikes, utilization gauges, counters, heartbeats that stop for a
    while, and the doctor's own slo events (which it must ignore)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(160):
        slow = 60 <= i < 90
        out.append({"type": "span", "name": "lm_train_step",
                    "phase": "train", "rank": 0,
                    "dur": float((0.4 if slow else 0.1)
                                 + 0.01 * rng.random())})
        loss = 3.0 - i / 100 + 0.01 * rng.standard_normal()
        if i in (50, 51, 130):
            loss += 40.0
        out.append({"type": "gauge", "name": "loss", "phase": "train",
                    "rank": 0, "value": float(loss)})
        out.append({"type": "gauge", "name": "slot_utilization",
                    "phase": "serve", "rank": 1,
                    "value": float(0.3 if 100 <= i < 120 else 0.9)})
        out.append({"type": "counter", "name": "steps", "phase": "train",
                    "rank": 0, "inc": 1})
        if not 70 <= i < 110:
            out.append({"type": "event", "name": "heartbeat",
                        "phase": "gang", "rank": 0})
        if i % 40 == 0:
            out.append({"type": "event", "name": "slo_breach",
                        "phase": "slo", "rank": 0})
    return out


def _rules(mon):
    return [
        mon.SloRule(name="step_p95", metric="lm_train_step", threshold=200.0,
                    window=16, agg="p95", severity="critical"),
        mon.SloRule(name="step_p50", metric="lm_train_step", threshold=200.0,
                    window=8, agg="p50", min_samples=4),
        mon.SloRule(name="step_max", metric="lm_train_step", threshold=300.0,
                    window=4, agg="max", phase="train", rank=0),
        mon.SloRule(name="loss_spike", metric="loss", threshold=0.5,
                    window=32, agg="spike", record="gauge"),
        mon.SloRule(name="loss_last", metric="loss", threshold=1.0, op=">=",
                    agg="last", record="gauge"),
        mon.SloRule(name="util", metric="slot_utilization", threshold=0.5,
                    op=">=", window=6, agg="mean", record="gauge"),
        mon.SloRule(name="util_min", metric="slot_utilization",
                    threshold=0.5, op=">=", window=6, agg="min",
                    record="gauge", rank=1, severity="info"),
        mon.SloRule(name="steps", metric="steps", threshold=1.0,
                    agg="mean", record="counter"),
        mon.SloRule(name="hb_age", metric="heartbeat", threshold=5.0,
                    agg="age", record="event"),
    ]


def test_doctor_transitions_and_events_equal_jax(tmp_path, monkeypatch):
    """One seeded stream through both doctors, on one pinned clock (a
    record a second, ``check`` at each): the same breach and clear
    transitions in the same order, the same hook calls, the same final
    states and the same slo events on each package's stream."""
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    runs = []
    for mon, tel_mod in PACKAGES:
        clock[0] = 100.0
        tel_mod.enable(str(tmp_path / tel_mod.__name__.split(".")[0]),
                       rank=0)
        doctor = mon.RunDoctor(_rules(mon), check_every=3)
        seen = []
        doctor.on_breach(lambda st: seen.append(("breach", st.rule.name,
                                                 st.current)))
        doctor.on_clear(lambda st: seen.append(("clear", st.rule.name,
                                                st.current)))
        doctor.on_breach(lambda st: 1 / 0)  # a broken hook is contained
        for rec in _stream():
            clock[0] += 0.25
            doctor.observe(rec)
            if rec["type"] == "event":
                doctor.check()
        doctor.check(now=clock[0] + 60.0)
        tel_mod.disable()
        runs.append((seen, doctor.summary()))
    (jseen, jsum), (tseen, tsum) = runs
    assert tseen == jseen
    assert {k for _, k, _ in tseen} >= {"step_p95", "step_max",
                                        "loss_spike", "util", "util_min",
                                        "hb_age"}
    assert any(kind == "clear" for kind, _, _ in tseen)
    assert json.dumps(tsum, sort_keys=True) == json.dumps(jsum,
                                                          sort_keys=True)
    want = _records(tmp_path / "distributed_pytorch_tpu")
    got = _records(tmp_path / "distributed_pytorch_tpu_torch")
    assert got == want
    assert sum(r.get("name") == "slo_breach" for r in got[0]) == \
        sum(kind == "breach" for kind, _, _ in tseen)


def test_doctor_attaches_to_the_live_registry(tmp_path):
    """``attach`` subscribes to the active registry: a windowed mean
    breaches once and clears once, its own slo events never feed back,
    and ``detach`` stops the feed.  (The JAX registry's ``unsubscribe``
    tests identity, which a bound method never passes, so a detached JAX
    doctor keeps observing the registry it was attached to; the port
    compares by equality, ROADMAP.md queue 3.)"""
    tel = ttel.enable(str(tmp_path), rank=0)
    doctor = tmon.RunDoctor([tmon.SloRule(
        name="lat", metric="latency_ms", threshold=100.0, window=4,
        agg="mean", record="gauge", min_samples=2)])
    assert doctor.attach()
    tel.gauge("latency_ms", 50.0, phase="serve")
    for _ in range(3):
        tel.gauge("latency_ms", 500.0, phase="serve")
    st = doctor.states["lat"]
    assert st.breached and st.breaches == 1
    for _ in range(4):
        tel.gauge("latency_ms", 1.0, phase="serve")
    assert not st.breached and st.samples == 8
    doctor.detach()
    tel.gauge("latency_ms", 900.0, phase="serve")
    assert st.samples == 8 and tel._subs == []
    ttel.disable()
    ev = ttel.run_summary(str(tmp_path))["events"]
    assert ev["rank0/slo/slo_breach"]["count"] == 1
    assert ev["rank0/slo/slo_clear"]["count"] == 1
    assert not tmon.RunDoctor([]).attach()  # no registry: nothing to feed


def test_run_tailer_incremental_and_torn_tail(tmp_path):
    tel = ttel.Telemetry(str(tmp_path), rank=2)
    tailers = [tmon.RunTailer(str(tmp_path)), jmon.RunTailer(str(tmp_path))]
    tel.gauge("g", 1.0, phase="serve")
    for t in tailers:
        assert [r["type"] for r in t.poll()] == ["epoch", "gauge"]
        assert t.poll() == []
    tel.gauge("g", 2.0, phase="serve")
    tel.close()
    with open(tel.path, "a") as f:
        f.write('{"type": "gauge", "name": "torn", "val')
    polls = [t.poll() for t in tailers]
    assert polls[0] == polls[1] and [r["value"] for r in polls[0]] == [2.0]
    with open(tel.path, "a") as f:
        f.write('ue": 9.0, "phase": "serve", "rank": 2, "ts": 1.0}\n')
    doctor = tmon.RunDoctor([tmon.SloRule(
        name="torn", metric="torn", threshold=1.0, agg="last",
        record="gauge")])
    assert doctor.pump(tailers[0]) == 1
    assert doctor.states["torn"].breached
    assert tmon.RunTailer(str(tmp_path / "missing")).poll() == []


def test_default_rules_json_and_evaluate_run_equal_jax(tmp_path):
    """The stock rules round-trip through JSON (either package reads the
    other's file), and ``evaluate_run`` over one run directory equals
    JAX's, breaches, currents and windows alike."""
    rules = tmon.default_rules(step_ms_p95=123.0, device_peak_bytes=1e9)
    assert [r.to_dict() for r in rules] == [
        r.to_dict() for r in jmon.default_rules(step_ms_p95=123.0,
                                                device_peak_bytes=1e9)]
    assert [r.name for r in tmon.default_rules()] == [
        "step_time", "heartbeat_fresh", "slot_utilization",
        "fleet_handoff"]
    path = tmp_path / "rules.json"
    path.write_text(json.dumps([r.to_dict() for r in rules]))
    assert tmon.rules_from_json(str(path)) == rules
    assert [r.to_dict() for r in jmon.rules_from_json(str(path))] == \
        [r.to_dict() for r in rules]
    run = tmp_path / "run"
    tel = ttel.Telemetry(str(run), rank=0)
    for i, v in enumerate((0.1, 0.2, 0.1, 0.9)):
        tel.gauge("slot_utilization", v, phase="serve")
        tel.span_at("lm_train_step", 10.0 + i, 0.05 + 0.1 * i,
                    phase="train")
        tel.event("heartbeat", phase="gang")
        tel.gauge("device_peak_bytes", 2e9 * (i == 2), phase="mem")
    tel.close()
    agent = ttel.Telemetry(str(run), rank=-1, label="agent")
    agent.observe("handoff_ms", 9000.0, phase="fleet")
    agent.close()
    # an observed metric's age is the run's last timestamp less the
    # replay's own clock at the observation (both packages), so the clock
    # is pinned for the two replays
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "perf_counter", lambda: 12345.0)
        got = tmon.evaluate_run(str(run), rules)
        want = jmon.evaluate_run(str(run), jmon.rules_from_json(str(path)))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["step_time"]["breached"] and got["fleet_handoff"]["breached"]
    assert got["device_memory_watermark"]["breached"]
    assert got["heartbeat_fresh"]["samples"] == 4


# -- profiling lanes ---------------------------------------------------------

def test_memory_lanes_trees_rss_and_gauges(tmp_path):
    """Tree bytes are numel x element_size over the tensors (a step count
    adds nothing), host RSS is read, no device figures on the CPU, and
    ``record_memory`` emits a gauge each (nothing while telemetry is
    off)."""
    tree = {"params": {"w": torch.zeros(3, 5), "b": torch.zeros(
        7, dtype=torch.bfloat16)}, "count": 4,
        "mu": [torch.zeros(2, dtype=torch.float64), np.zeros(3, np.int8)]}
    assert tmon.tree_nbytes(tree) == 60 + 14 + 16 + 3
    assert tmon.tree_nbytes(None) == 0
    assert tmon.host_rss_bytes() > 0
    assert tmon.record_memory(params=tree) is None  # off: nothing
    assert tmon.device_memory_stats() == {}  # no CUDA in use here
    tel = ttel.enable(str(tmp_path), rank=0)
    wm = tmon.record_memory(params=tree["params"], opt=tree["mu"])
    ttel.disable()
    assert wm["trees"] == {"params": 74, "opt": 19} and wm["devices"] == {}
    (_, recs), = ttel.read_run(str(tmp_path))
    assert [(r["phase"], r["name"], r["value"]) for r in recs][1:] == [
        ("mem", "params_bytes", 74), ("mem", "opt_bytes", 19)]
    assert recs[0]["name"] == "host_rss_bytes" and tel is not None


def _fake_cuda(monkeypatch, stats: dict):
    cuda = torch.cuda
    monkeypatch.setattr(cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(cuda, "current_device", lambda: 1)
    monkeypatch.setattr(cuda, "memory_stats", lambda i: dict(stats))
    monkeypatch.setattr(cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(total_memory=80e9))


def test_device_memory_from_torch_cuda_and_never_hidden(tmp_path,
                                                        monkeypatch):
    """With CUDA in use, the device's figures are the allocator's
    ``allocated_bytes.all.current`` / ``.peak`` (what
    ``memory_allocated`` and ``max_memory_allocated`` report) and land as
    the device gauges; an allocator that reports none is an error, not an
    empty dict."""
    _fake_cuda(monkeypatch, {"allocated_bytes.all.current": 123,
                             "allocated_bytes.all.peak": 456,
                             "reserved_bytes.all.current": 999})
    assert tmon.device_memory_stats() == {"1": {
        "live_bytes": 123, "peak_bytes": 456, "limit_bytes": 80_000_000_000}}
    ttel.enable(str(tmp_path), rank=0)
    tmon.record_memory(params={"w": torch.zeros(4)})
    ttel.disable()
    (_, recs), = ttel.read_run(str(tmp_path))
    assert {r["name"]: r["value"] for r in recs}["device_peak_bytes"] == 456
    _fake_cuda(monkeypatch, {})
    with pytest.raises(RuntimeError, match="allocated_bytes"):
        tmon.device_memory_stats()
    # the flight recorder stays safe: a failing lane loses the bundle,
    # never raises on the failure path
    assert tmon.write_postmortem("worker_fault",
                                 run_dir=str(tmp_path)) is None


def test_compile_span_lane_equals_jax(tmp_path):
    """A build point emits one compile-lane span tagged with the key's
    hash (the JAX package's ``program_key``) and its arguments, and a
    cache-size gauge when asked; off, nothing."""
    key = ("spmd", 1.0, (("data", 4),))
    assert tmon.program_key(key) == jmon.program_key(key)
    for mon, tel_mod in PACKAGES:
        with mon.compile_span("lm_step_build", key=key):  # off
            pass
        tel_mod.enable(str(tmp_path / tel_mod.__name__.split(".")[0]),
                       rank=0)
        with mon.compile_span("lm_step_build", key=key, kind="spmd"):
            pass
        with mon.compile_span("aot_compile", cache_size=lambda: 3):
            pass
        with mon.compile_span("bad", cache_size=lambda: 1 / 0):
            pass
        with pytest.raises(KeyError):
            with mon.compile_span("kernel_build", library="x"):
                raise KeyError("build failed")
        tel_mod.disable()
    want = _records(tmp_path / "distributed_pytorch_tpu")
    got = _records(tmp_path / "distributed_pytorch_tpu_torch")
    assert got == want
    assert [(r["phase"], r["name"]) for r in got[0][1:]] == [
        ("compile", "lm_step_build"), ("compile", "aot_compile"),
        ("compile", "aot_compile_cache_size"), ("compile", "bad"),
        ("compile", "kernel_build")]
    assert got[0][1]["args"] == {"kind": "spmd",
                                 "program": tmon.program_key(key)}


# -- flight recorder ---------------------------------------------------------

def _bundle_run(tmp_path, mon, tel_mod):
    tel = tel_mod.enable(str(tmp_path), rank=0)
    tel.gauge("slot_utilization", 0.1, phase="serve")
    tel.gauge("loss", float("nan"), phase="train")
    mon.log_line("worker 1 looked unwell")
    doctor = mon.RunDoctor([mon.SloRule(
        name="util", metric="slot_utilization", threshold=0.5, op=">=",
        agg="mean", record="gauge")])
    doctor.observe({"type": "gauge", "name": "slot_utilization",
                    "phase": "serve", "rank": 0, "value": 0.1})
    path = mon.write_postmortem(
        "worker_fault", doctor=doctor, detail={"rank": 1, "code": 77,
                                               "kind": "overridden"},
        gang={"world_size": 2, "gen": 0}, serve_stats={"tokens": 12},
        memory={"host_rss_bytes": 5e8, "trees": {"params": 4e6},
                "devices": {"0": {"live_bytes": 1e9, "peak_bytes": 2e9,
                                  "limit_bytes": 8e10}}})
    tel_mod.disable()
    return path


def test_postmortem_bundle_strict_json_and_format_equal_jax(tmp_path):
    """A bundle of the port's is strict JSON with every ``BUNDLE_KEYS``
    key, its trigger class winning over the detail's ``kind``; each
    package's ``load_postmortem`` reads the other's; and
    ``format_postmortem`` renders one bundle to the JAX package's text."""
    assert tmon.BUNDLE_KEYS == jmon.BUNDLE_KEYS
    assert tmon.TRIGGERS == jmon.TRIGGERS
    path = _bundle_run(tmp_path / "port", tmon, ttel)
    with open(path) as f:
        json.loads(f.read(), parse_constant=tmon._strict)
    bundle = tmon.load_postmortem(path)
    assert set(tmon.BUNDLE_KEYS) <= set(bundle)
    assert bundle["trigger"] == {"rank": 1, "code": 77,
                                 "kind": "worker_fault"}
    assert bundle["slo"]["util"]["breached"] is True
    assert bundle["log_tail"][-2].endswith("worker 1 looked unwell")
    assert "slo_breach: util" in bundle["log_tail"][-1]
    assert [r["name"] for r in bundle["ring"]][:2] == ["slot_utilization",
                                                       "loss"]
    assert jmon.load_postmortem(path) == bundle
    jpath = _bundle_run(tmp_path / "jax", jmon, jtel)
    assert tmon.load_postmortem(jpath) == jmon.load_postmortem(jpath)
    for b in (bundle, tmon.load_postmortem(jpath)):
        assert tmon.format_postmortem(b) == jmon.format_postmortem(b)
    assert tmon.find_postmortems(str(tmp_path / "port")) == [path]
    assert tmon.find_postmortems(str(tmp_path / "missing")) == []


BAD_BUNDLES = {"missing_keys": {"version": 1},
               "version": "VERSION", "trigger": "TRIGGER", "nan": "NAN"}


@pytest.mark.parametrize("bad", list(BAD_BUNDLES))
def test_load_postmortem_refusals_equal_jax(tmp_path, bad):
    good = tmon.load_postmortem(_bundle_run(tmp_path, tmon, ttel))
    path = tmp_path / f"{tmon.BUNDLE_PREFIX}bad.json"
    if bad == "missing_keys":
        text = json.dumps(BAD_BUNDLES[bad])
    elif bad == "version":
        text = json.dumps(dict(good, version=2))
    elif bad == "trigger":
        text = json.dumps(dict(good, trigger={"kind": "meteor"}))
    else:
        text = json.dumps(dict(good, serve={"x": float("nan")}))
    path.write_text(text)
    msgs = []
    for mon, _ in PACKAGES:
        with pytest.raises(ValueError) as e:
            mon.load_postmortem(str(path))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_write_postmortem_guards(tmp_path, monkeypatch):
    """An unknown trigger, or no run directory, gives None and never
    raises (the failure path must go on); the launcher's
    ``TELEMETRY_DIR`` is not a registry, so ``write_postmortem`` needs the
    directory passed."""
    assert tmon.write_postmortem("bogus", run_dir=str(tmp_path)) is None
    monkeypatch.setenv(ttel.TELEMETRY_DIR_ENV, str(tmp_path))
    assert tmon.write_postmortem("worker_fault") is None
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    path = tmon.write_postmortem("worker_fault", run_dir=str(tmp_path))
    b = tmon.load_postmortem(path)
    assert b["gang"] == jmon.gang_from_env() == {"rank": "3",
                                                 "world_size": "4"}
    assert b["ring"] == [] and b["memory"]["devices"] == {}
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def _capture(fn, *args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(*args)
    return rc, out.getvalue(), err.getvalue()


def test_scripts_print_what_the_jax_scripts_print(tmp_path):
    """On one run directory (a port-written run with a gang event, an SLO
    breach and a postmortem bundle), each port script's output and exit
    code equal its JAX counterpart's: the tables, ``--json``, ``--slo``
    (exit 2 on a breach), ``--postmortem``, ``--chrome-trace``'s file, and
    the postmortem renderer's report, ``--json`` and refusal."""
    sc = _scripts()
    tel = ttel.enable(str(tmp_path), rank=0)
    for i in range(5):
        tel.span_at("lm_train_step", 1.0 + i, 1.5, phase="train")
        tel.gauge("loss", 3.0 - i, phase="train", step=i)
    tel.counter("steps", 5, phase="train")
    tel.event("worker_exit", phase="gang", rank=1, code=3, gen=0)
    tel.observe("handoff_ms", 10.0, phase="fleet")
    tmon.write_postmortem("worker_fault", detail={"rank": 1, "code": 3},
                          gang={"world_size": 2})
    ttel.disable()
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps([r.to_dict() for r in tmon.default_rules(
        step_ms_p95=1000.0)]))
    run = str(tmp_path)
    jsum, tsum = sc["summary"]
    for argv in ([run], [run, "--json"], [run, "--slo"],
                 [run, "--slo", "--rules", str(rules)],
                 [run, "--max-events", "2"], ["--postmortem", run]):
        want, got = _capture(jsum.main, argv), _capture(tsum.main, argv)
        assert got == want, argv
        assert got[1]
    assert _capture(tsum.main, [run, "--slo"])[0] == 2
    trace = str(tmp_path / "trace.json")
    outs = []
    for mod in (jsum, tsum):
        _capture(mod.main, [run, "--chrome-trace", trace])
        with open(trace) as f:
            outs.append(json.load(f))
    assert outs[0] == outs[1] and outs[1]["traceEvents"]
    jpm, tpm = sc["postmortem"]
    for argv in ([run], [run, "--json"], [str(tmp_path / "none.json")]):
        assert _capture(tpm.main, argv) == _capture(jpm.main, argv), argv
    assert _capture(tpm.main, [run])[0] == 0
