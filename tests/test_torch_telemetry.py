"""The port's telemetry layer (distributed_pytorch_tpu_torch/utils:
telemetry.py, logging.py, metrics.py's window gauges and SpikeDetector,
tracing.py) against the JAX package's, on the CPU.

Both packages write the same records: the same calls on the two registries
give equal records once the clock and host fields are dropped (``ts``,
``dur``, ``wall``, ``mono``, ``pid``, ``host``), and each package's
exporter reads the other's run directory exactly as its own.  The port's
telemetry, monitor and logging modules import no torch, and the launcher
agent with ``--telemetry-dir`` stays torch-free.  Telemetry off is bitwise
free for the LM windows (a 2-rank Gloo gang through
tests/workers/torch_dp_worker.py mode ``lm``).
"""

import json
import logging as pylogging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.utils import metrics as jmetrics
from distributed_pytorch_tpu.utils import telemetry as jtel
from distributed_pytorch_tpu.utils import tracing as jtracing
from distributed_pytorch_tpu_torch.utils import logging as tlog
from distributed_pytorch_tpu_torch.utils import metrics as tmetrics
from distributed_pytorch_tpu_torch.utils import telemetry as ttel
from distributed_pytorch_tpu_torch.utils import tracing as ttracing
from workers.torch_dp_worker import run_gang, shared_result

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCKS = ("ts", "dur", "wall", "mono", "pid", "host")


@pytest.fixture(autouse=True)
def _clean_registries():
    jtel.disable()
    ttel.disable()
    yield
    jtel.disable()
    ttel.disable()


def _records(run_dir):
    """Every file's records in order, epoch first, clock fields dropped."""
    out = []
    for name in sorted(os.listdir(run_dir)):
        if not name.startswith("events_"):
            continue
        with open(os.path.join(run_dir, name)) as f:
            out.append([{k: v for k, v in json.loads(line).items()
                         if k not in CLOCKS} for line in f])
    return out


def _drive(mod, run_dir, rank=3, gen=2, tag=""):
    """The same calls on one package's registry and emitters."""
    tel = mod.Telemetry(str(run_dir), rank=rank, gen=gen, tag=tag,
                        label="probe")
    tel.counter("steps", 2, phase="train")
    tel.counter("steps", 3, phase="train", note="x")
    tel.gauge("loss", 1.5, phase="train", step=7)
    tel.gauge("nan", float("nan"), phase="train")
    tel.gauge("inf", float("-inf"), phase="train")
    tel.event("worker_start", phase="gang", rank=1, gen=4)
    with tel.span("dispatch", phase="serve", k=2):
        pass
    tel.span_at("lm_train_step", 1.0, 0.25, phase="train", step0=3)
    tel.observe("latency", 0.25, phase="serve")
    losses = np.asarray([2.5, 2.25, float("nan")], np.float32)
    oks = np.asarray([1.0, 1.0, 0.0], np.float32)
    mets = np.asarray([[3.0, 30.0], [2.0, 31.0], [1.0, 32.0]], np.float32)
    mod.emit_train_steps(tel, time.perf_counter(), 10, 3, losses, oks, mets)
    mod.emit_train_steps(tel, time.perf_counter(), 13, 1, losses[:1],
                         oks[:1], mets[:1], span_name="lm_train_step")
    mod.emit_sync_windows(tel, time.perf_counter(), 10, 4, 2,
                          wire_bytes=1024)
    mod.emit_sync_windows(tel, time.perf_counter(), 10, 1, 2)  # no window
    mod.emit_window_plan(tel, step=11, sync_every_per_slice=(2, 4),
                         outer_steps=3)
    mod.emit_window_plan(tel, step=12)
    summary = tel.summary()
    tel.close()
    return summary


@pytest.mark.parametrize("tag", ["", "_replica"])
def test_records_equal_jax(tmp_path, tag):
    """Field for field, in order: the epoch, every instrument, the three
    emitters (an unhealthy step's event included), NaN and -inf gauges as
    strict-JSON strings; the same file name; the same in-memory summary
    (span timings aside)."""
    js = _drive(jtel, tmp_path / "jax", tag=tag)
    ts = _drive(ttel, tmp_path / "port", tag=tag)
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert got == want and len(got[0]) > 30
    assert got[0][0]["type"] == "epoch" and got[0][0]["label"] == "probe"
    assert [n.replace(str(os.getpid()), "P") for n in
            os.listdir(tmp_path / "port")] == [
        f"events_rank3_gen2_P{tag}.jsonl"]
    for s in (js, ts):
        for v in s["spans"].values():
            v.pop("total_s"), v.pop("max_s")
    assert json.dumps(ttel._jsonsafe(ts), sort_keys=True) == \
        json.dumps(jtel._jsonsafe(js), sort_keys=True)


def test_jsonsafe_takes_tensors_and_numpy_scalars(tmp_path):
    """A 0-dim tensor or numpy scalar gauges as its number; non-finite
    ones as JAX's strings."""
    tel = ttel.enable(str(tmp_path), rank=0)
    tel.gauge("t", torch.tensor(2.5), phase="train")
    tel.gauge("n", np.float32(0.5), phase="train",
              step=torch.tensor(4, dtype=torch.int64))
    tel.gauge("x", torch.tensor(float("nan")), phase="train")
    ttel.disable()
    (_, recs), = ttel.read_run(str(tmp_path))
    assert [(r["value"], r.get("args")) for r in recs] == [
        (2.5, None), (0.5, {"step": 4}), ("NaN", None)]
    assert ttel._jsonsafe({"a": [torch.tensor(1.0)]}) == {"a": [1.0]}


def _write_run(mod, run_dir):
    """Two ranks, a restarted rank 0 and the agent: the exporter's
    cases (generations, caller gens, counters summed over registries)."""
    a = mod.Telemetry(str(run_dir), rank=0, gen=0)
    b = mod.Telemetry(str(run_dir), rank=1, gen=0)
    for t in (a, b):
        with t.span("train_steps", phase="train"):
            with t.span("inner", phase="train"):
                pass
        t.counter("steps", 4, phase="train")
        t.gauge("loss", float("nan"), phase="train")
    agent = mod.Telemetry(str(run_dir), rank=-1, gen=0, label="agent")
    agent.event("gang_resize", phase="gang", kind="shrink", gen=2)
    a.close(), b.close()
    time.sleep(0.01)
    c = mod.Telemetry(str(run_dir), rank=0, gen=1)
    c.counter("steps", 3, phase="train")
    c.observe("latency", 0.5, phase="serve")
    c.close()
    agent.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_exporters_read_each_others_runs(tmp_path, writer):
    """JAX's read_run, merge_chrome_trace and run_summary on a directory
    the port wrote equal the port's own, and the reverse."""
    _write_run(ttel if writer == "port" else jtel, tmp_path)
    run = str(tmp_path)
    assert ttel.read_run(run) == jtel.read_run(run)
    trace = ttel.merge_chrome_trace(run)
    assert trace == jtel.merge_chrome_trace(run)
    json.loads(json.dumps(trace, allow_nan=False))  # strict JSON
    summary = ttel.run_summary(run)
    assert summary == jtel.run_summary(run)
    assert summary["counters"]["rank0/train/steps"] == 7
    assert summary["ranks"] == [-1, 0, 1] and 2 in summary["generations"]
    assert {e["pid"] for e in trace["traceEvents"]} == {-1, 0, 1}


def test_ring_bound_and_torn_tail(tmp_path):
    """The in-memory ring holds the last ``ring`` records while the sink
    gets every one; a torn final line is skipped by both readers."""
    tel = ttel.Telemetry(str(tmp_path), rank=0, ring=16, flush_every=1000)
    for i in range(100):
        tel.gauge("g", float(i), phase="serve")
    assert len(tel.recent) == 16 and tel.recent[-1]["value"] == 99.0
    assert len(tel._pending) == 100  # buffered below flush_every
    tel.close()
    with open(tel.path, "a") as f:
        f.write('{"type": "gauge", "name": "torn", "ph')
    for mod in (ttel, jtel):
        (_, recs), = mod.read_run(str(tmp_path))
        assert len(recs) == 100 and recs[-1]["value"] == 99.0


def test_enable_disable_cycles_release_registries(tmp_path):
    import gc
    import weakref
    refs = []
    for _ in range(5):
        tel = ttel.enable(str(tmp_path), rank=0)
        tel.gauge("g", 1.0)
        refs.append(weakref.ref(tel))
        del tel
        ttel.disable()
    gc.collect()
    assert all(r() is None for r in refs), "closed registries still pinned"
    # five registries of one process append to one file, an epoch each
    (path,) = os.listdir(tmp_path)
    with open(tmp_path / path) as f:
        types = [json.loads(line)["type"] for line in f]
    assert types == ["epoch", "gauge"] * 5


def test_enable_from_cli_rank_precedence(tmp_path, monkeypatch):
    """``RANK`` first, then the rank of an initialised default process
    group (an in-process one-rank Gloo group; its get_rank patched to 5 to
    tell it from the fallback), then 0; and off without a directory."""
    import torch.distributed as dist
    monkeypatch.delenv(ttel.TELEMETRY_DIR_ENV, raising=False)
    assert ttel.enable_from_cli(None) is None and ttel.active() is None
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 5)
    monkeypatch.delenv("RANK", raising=False)
    assert ttel.enable_from_cli(str(tmp_path)).rank == 0  # no group
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        assert ttel.enable_from_cli(str(tmp_path)).rank == 5
        assert tlog.current_rank() == 5
        monkeypatch.setenv("RANK", "7")
        assert ttel.enable_from_cli(str(tmp_path)).rank == 7
        monkeypatch.setenv("RANK", "bogus")
        assert ttel.enable_from_cli(str(tmp_path)).rank == 5
    finally:
        dist.destroy_process_group()
    monkeypatch.setenv(ttel.TELEMETRY_DIR_ENV, str(tmp_path / "env"))
    monkeypatch.setenv("RANK", "2")
    tel = ttel.enable_from_cli(None)  # the launcher's export
    assert tel.run_dir == str(tmp_path / "env") and tel.rank == 2
    assert ttel.child_env() == {ttel.TELEMETRY_DIR_ENV:
                                str(tmp_path / "env")}
    ttel.disable()
    assert ttel.maybe_enable() is not None


def test_phase_timer_and_metric_windows_equal_jax(tmp_path, monkeypatch):
    """PhaseTimer re-emits each segment as a span in its component's lane
    (nothing while telemetry is off), and the reference's loss/20 and
    time/40 windows land as gauges: the same records as the JAX package's
    (the clock pinned for both)."""
    clock = iter(np.arange(1000.0, 2000.0, 0.5))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    for mod, tr, mt in ((jtel, jtracing, jmetrics),
                        (ttel, ttracing, tmetrics)):
        timer = tr.PhaseTimer(component="serve")
        timer.add("host_plan", 0.002)  # off: no registry, no record
        mod.enable(str(tmp_path / mod.__name__.split(".")[0]), rank=0)
        with timer.phase("dispatch"):
            pass
        timer.add("fetch", 0.004)
        tr.PhaseTimer(component="fleet").add("route", 0.001)
        lm, tm = mt.LossMeter(), mt.IterTimeMeter()
        for i in range(45):
            lm.update(i, 2.0 + i)
            tm.update(i, 0.5)
        mod.disable()
        assert timer.summary()["_total_s"] == pytest.approx(0.5 + 0.006)
    want = _records(tmp_path / "distributed_pytorch_tpu")
    got = _records(tmp_path / "distributed_pytorch_tpu_torch")
    assert got == want
    names = [(r["phase"], r["name"]) for r in got[0][1:]]
    assert names[:3] == [("serve", "dispatch"), ("serve", "fetch"),
                         ("fleet", "route")]
    assert names.count(("train", "window_loss")) == 2
    assert names.count(("train", "window_iter_seconds")) == 1


def test_step_timer_equals_jax(monkeypatch):
    clock = iter(np.cumsum(np.random.default_rng(0).random(64)))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    sums = []
    for tr in (jtracing, ttracing):
        timer = tr.StepTimer(skip_first=2)
        assert timer.summary() == {}
        for _ in range(9):
            with timer:
                pass
        sums.append(timer.summary())
    assert sums[0].keys() == sums[1].keys() and sums[1]["steps"] == 7
    # the clock advanced between the two loops: compare each timer's own
    # durations through the same statistic shapes
    assert all(np.isfinite(v) for v in sums[1].values())


def test_spike_detector_flags_equal_jax():
    """A seeded series with injected spikes, a plateau and non-finite
    values: the same flags and bounds at every step, for several
    settings."""
    rng = np.random.default_rng(11)
    series = list(2.0 + 0.05 * rng.standard_normal(300))
    for i in (40, 41, 120, 200):
        series[i] += 5.0 * (1 + i % 3)
    series[150:170] = [3.0] * 20
    series[250] = float("nan")
    series[260] = float("inf")
    for kw in (dict(), dict(window=8, threshold=3.0, min_history=4),
               dict(window=64, min_sigma=0.5)):
        j, t = jmetrics.SpikeDetector(**kw), tmetrics.SpikeDetector(**kw)
        flags = []
        for v in series:
            assert t.bound() == j.bound()
            f = t.update(v)
            assert f == j.update(v)
            flags.append(f)
        assert sum(flags) >= 4
    for mod in (jmetrics, tmetrics):
        with pytest.raises(ValueError, match="window must be >= 2"):
            mod.SpikeDetector(window=1)


def test_trace_writes_a_chrome_trace_with_step_ranges(tmp_path):
    """``trace`` writes one torch.profiler Chrome trace into the
    directory, holding the operators run inside and the
    ``annotate_step`` ranges."""
    x = torch.ones(64, 64)
    with ttracing.trace(str(tmp_path)):
        for step in range(3):
            with ttracing.annotate_step(step):
                x = x @ x / 64
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert [n for n in names if n.startswith("train_step#")] == [
        "train_step#0", "train_step#1", "train_step#2"]
    assert sum(n == "aten::mm" for n in names) == 3


def test_lazy_host_makes_one_copy(monkeypatch):
    """``lazy_host`` reads three tensors in one concatenation and copy, at
    the first read, after which every view is served from it."""
    calls = []
    real = torch.cat
    monkeypatch.setattr(torch, "cat",
                        lambda t, *a, **k: calls.append(len(t))
                        or real(t, *a, **k))
    loss, ok = torch.tensor(1.25), torch.tensor(1.0)
    met = torch.tensor([[2.0, 3.0]], dtype=torch.float64)
    views = ttracing.lazy_host(loss, ok, met)
    assert calls == []
    got = [np.asarray(v) for v in views] + [np.asarray(views[0])]
    assert calls == [3]
    assert [g.tolist() for g in got] == [[1.25], [1.0], [2.0, 3.0], [1.25]]
    assert got[2].dtype == np.float32
    assert np.asarray(views[1], dtype=np.float64).dtype == np.float64


def test_logging_resolves_rank_per_record_and_splits_streams(monkeypatch,
                                                             capsys):
    """One stdout handler (INFO, WARNING) and one stderr handler (ERROR
    and above), installed once; the rank read per record, never cached;
    the streams looked up at emit time."""
    tlog.setup_logging()
    tlog.setup_logging("debug")
    root = pylogging.getLogger("distributed_pytorch_tpu_torch")
    assert len(root.handlers) == 2 and root.level == pylogging.DEBUG
    out, err = root.handlers
    assert err.level == pylogging.ERROR and err.stream is sys.stderr
    assert out.stream is sys.stdout

    def fmt(level=20) -> str:
        rec = pylogging.LogRecord("distributed_pytorch_tpu_torch.t", level,
                                  __file__, 1, "hello", (), None)
        assert out.filter(rec)
        return out.formatter.format(rec)

    err_rec = pylogging.LogRecord("x", 40, __file__, 1, "boom", (), None)
    assert not out.filter(err_rec) and err.filter(err_rec)
    monkeypatch.delenv("RANK", raising=False)
    assert "rank0 " in fmt()
    monkeypatch.setenv("RANK", "3")
    assert "rank3 " in fmt()
    monkeypatch.setenv("RANK", "bogus")
    assert "rank0 " in fmt()
    monkeypatch.setenv("RANK", "4")
    log = tlog.get_logger("probe")
    log.info("to stdout")
    log.error("to stderr")
    cap = capsys.readouterr()
    assert "rank4 distributed_pytorch_tpu_torch.probe INFO: to stdout" \
        in cap.out and "to stderr" not in cap.out
    assert "ERROR: to stderr" in cap.err
    tlog.setup_logging()


PROBE = """
import json, sys
from distributed_pytorch_tpu_torch.utils import logging, monitor, telemetry
import distributed_pytorch_tpu_torch.launch as launch
mods = sorted(m for m in sys.modules if m == "torch" or
              m.startswith("torch.") or m == "jax" or m.startswith("jax."))
rc = launch.main(["--telemetry-dir", sys.argv[1], "--monitor-interval",
                  "0.05", "--", "-c", "pass"])
mods += sorted(m for m in sys.modules if m == "torch" or
               m.startswith("torch."))
print(json.dumps({"rc": rc, "mods": mods}))
"""


def test_agent_and_telemetry_modules_import_no_torch(tmp_path):
    """telemetry, monitor and logging import no torch, and neither does
    the launcher's agent running a gang with --telemetry-dir; the run
    directory holds the agent's file (rank -1) and the worker's export."""
    proc = subprocess.run(
        [sys.executable, "-c", PROBE, str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"rc": 0, "mods": []}
    summary = ttel.run_summary(str(tmp_path))
    assert summary["ranks"] == [-1]
    assert summary["events"]["rank-1/gang/worker_start"]["count"] == 1
    assert summary["events"]["rank-1/gang/gang_done"]["count"] == 1


# -- telemetry off is free on the LM windows (a 2-rank gang) ----------------

WIN_MODEL = dict(vocab_size=256, d_model=32, n_layers=1, n_heads=1,
                 head_dim=32, d_ff=64)


@pytest.fixture(scope="module")
def window_gang(tmp_path_factory):
    """A 2-rank gang, two slices of one rank, windows of 2 steps under the
    nesterov outer optimizer, 4 steps: once with telemetry off and once
    with it on (each rank streaming into one shared run directory)."""
    def compute():
        from distributed_pytorch_tpu_torch.models import transformer as ttfm
        root = str(tmp_path_factory.mktemp("tel_window_gang"))
        run_dir = os.path.join(root, "run")
        init = ttfm.init(3, ttfm.TransformerConfig(**WIN_MODEL),
                         device="cpu")
        rng = np.random.default_rng(5)
        tokens = rng.integers(0, 256, (4, 32)).astype(np.int32)
        targets = np.roll(tokens, -1, 1).astype(np.int32)
        cfg = dict(dcn_size=2, sync_every=2, outer_opt="nesterov")
        cases = {name: dict(model=WIN_MODEL, steps=4, cfg=cfg,
                            **({"telemetry": run_dir} if name == "on"
                               else {}))
                 for name in ("off", "on")}
        outs = run_gang("lm", {"tokens": tokens, "targets": targets,
                               **{f"p/{k}": v.numpy()
                                  for k, v in init.items()}},
                        os.path.join(root, "gang"), world=2, cases=cases)
        res = {f"rank{r}:{k}": v for r, out in enumerate(outs)
               for k, v in out.items()}
        res["summary"] = np.asarray(json.dumps(ttel.run_summary(run_dir)))
        return res
    return shared_result(tmp_path_factory, "torch_telemetry_window_gang",
                         compute)


def test_lm_window_telemetry_off_is_bitwise_free(window_gang):
    """Losses, metrics, whole params, deltas and outer momenta bitwise
    equal with telemetry on and off; the run streamed a step span and
    three gauges a step, a window span with its wire bytes and the outer
    step count at each of the 2 boundaries, and each rank's gauges are
    the losses its trainer returned."""
    g = window_gang
    keys = {k.split(":", 1)[1][len("off/"):] for k in g
            if k.startswith("rank0:off/")}
    assert {"losses", "met"} <= keys and any(k.startswith("p/")
                                             for k in keys)
    for r in range(2):
        for k in keys:
            np.testing.assert_array_equal(g[f"rank{r}:on/{k}"],
                                          g[f"rank{r}:off/{k}"], err_msg=k)
    s = json.loads(str(g["summary"]))
    assert s["ranks"] == [0, 1]
    for r in range(2):
        pre = f"rank{r}/train/"
        assert s["spans"][pre + "lm_train_step"]["count"] == 4
        assert s["spans"][pre + "sync_window"]["count"] == 2
        assert s["counters"][pre + "steps"] == 4
        assert s["counters"][pre + "sync_windows"] == 2
        for name in ("loss", "grad_norm", "param_norm"):
            assert s["gauges"][pre + name]["count"] == 4
        assert s["gauges"][pre + "loss"]["last"] == \
            float(np.float32(g[f"rank{r}:on/losses"][-1]))
        assert s["gauges"][pre + "outer_opt_steps"] == {"count": 2,
                                                        "last": 2.0}
        assert s["gauges"][pre + "window_wire_bytes"]["count"] == 2
        assert s["spans"][f"rank{r}/compile/lm_step_build"]["count"] == 1
