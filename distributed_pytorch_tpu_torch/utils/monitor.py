"""Run doctor: online SLO monitors, profiling lanes and postmortems.

The port of the JAX package's utils/monitor.py, the consumer of the
telemetry stream (utils/telemetry.py) while the run is alive:

- **Profiling lanes**: ``record_memory`` (the device's allocated and peak
  bytes from ``torch.cuda.memory_stats``, the bytes of named tensor trees,
  host RSS) and ``compile_span`` (the time of a build point: a trainer's
  step construction, a kernel library's nvcc build) ride the record schema,
  so they land in the same merged Chrome trace as everything else.
- **SLO monitors**: declarative ``SloRule``s (metric, window, threshold,
  severity) evaluated online by a ``RunDoctor``, in-process (a
  ``Telemetry.subscribe`` feed) or across processes (a ``RunTailer`` over
  the rank JSONL files).  Breaches emit events and fire hooks.
- **Flight recorder**: ``write_postmortem`` snapshots the last-N records,
  the SLO states, the gang, serve stats, memory and a log tail into one
  strict-JSON bundle at a failure (the launcher's ``worker_fault``);
  ``scripts/torch_postmortem.py`` renders it.
- **Hooks**: ``sentry_breach_hook`` turns a breach into the training
  sentry's resize rung.

Like telemetry.py this module imports no torch (the launcher agent imports
it): device figures are read through ``sys.modules.get("torch")``, so a
process that never loaded torch reports none, and one that loaded it with
CUDA in use must report its device or raise.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import socket
import sys
import time
from collections import deque
from dataclasses import dataclass, field

from . import telemetry
from .metrics import SpikeDetector

BUNDLE_VERSION = 1
BUNDLE_PREFIX = "postmortem_"

# the JAX package's trigger classes, so bundles cross between the packages;
# the port writes "worker_fault" (launch.py) so far, and the others come
# with the slices that own their failure points (ROADMAP.md queue 1)
TRIGGERS = ("sentry_abort", "worker_fault", "elastic_shrink",
            "replica_loss", "transport")
SEVERITIES = ("info", "warn", "critical")
AGGS = ("last", "mean", "max", "min", "p50", "p95", "spike", "age")
OPS = ("<=", ">=")
RECORD_TYPES = ("span", "gauge", "hist", "counter", "event")

# bundle keys every postmortem must carry (load_postmortem validates)
BUNDLE_KEYS = ("version", "trigger", "written_at", "host", "pid",
               "ring", "slo", "gang", "serve", "memory", "log_tail")


# ---------------------------------------------------------------------------
# module log ring: the "recent log tail" lane of the flight recorder.
# Subsystems route their log lines here (the launcher's agent passes each
# line through log_line) so a bundle shows what the operator saw.

_LOG_RING: deque = deque(maxlen=200)


def log_line(msg: str) -> None:
    """Append one line to the bounded module log ring (and nothing
    else: callers keep printing wherever they printed before)."""
    _LOG_RING.append(f"{time.time():.3f} {msg}")


def log_tail(n: int = 50) -> list[str]:
    return list(_LOG_RING)[-n:]


# ---------------------------------------------------------------------------
# profiling lanes

def host_rss_bytes() -> int:
    """This process's resident set size.  /proc is authoritative on
    Linux; the resource fallback covers everything else."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return int(ru.ru_maxrss) * 1024  # linux reports KiB
    except Exception:
        return 0


def tree_nbytes(tree) -> int:
    """Total bytes of a tree's tensor leaves (dicts, lists and tuples
    walked by hand): ``numel x element_size`` of each tensor, ``nbytes``
    of each array; other leaves (step counts) count nothing."""
    total = 0
    for leaf in _manual_leaves(tree):
        if hasattr(leaf, "element_size") and hasattr(leaf, "numel"):
            total += int(leaf.numel()) * int(leaf.element_size())
            continue
        nb = getattr(leaf, "nbytes", None)
        if nb is not None:
            try:
                total += int(nb)
            except (TypeError, ValueError):
                pass
    return total


def _manual_leaves(tree) -> list:
    out: list = []
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif node is not None:
            out.append(node)
    return out


def sys_torch():
    """torch, iff some other module already imported it: the launcher
    agent owns no device and never loads torch, so this module only ever
    looks at ``sys.modules``."""
    return sys.modules.get("torch")


def device_memory_stats() -> dict[str, dict]:
    """This process's device: live, peak and total bytes from
    ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` /
    ``.peak``, the figures ``torch.cuda.memory_allocated`` and
    ``max_memory_allocated`` report) and the card's memory, keyed by
    device index.  ``{}`` in a process that never loaded torch, or whose
    CUDA was never initialised (it holds no device memory); a process
    using CUDA whose allocator reports nothing raises rather than hiding
    the device."""
    torch = sys_torch()
    if torch is None:
        return {}
    cuda = torch.cuda
    if not (cuda.is_available() and cuda.is_initialized()):
        return {}
    i = cuda.current_device()
    ms = cuda.memory_stats(i)
    live = ms.get("allocated_bytes.all.current")
    peak = ms.get("allocated_bytes.all.peak")
    if live is None or peak is None:
        raise RuntimeError(
            f"torch.cuda.memory_stats({i}) reported no allocated_bytes "
            f"figures for a device in use: {sorted(ms)[:8]}")
    return {str(i): {
        "live_bytes": int(live), "peak_bytes": int(peak),
        "limit_bytes": int(cuda.get_device_properties(i).total_memory)}}


def memory_watermarks(**trees) -> dict:
    """One memory snapshot: host RSS, the device's stats, and the bytes of
    each named tree (params, optimizer state, a KV pool)."""
    return {
        "host_rss_bytes": host_rss_bytes(),
        "devices": device_memory_stats(),
        "trees": {name: tree_nbytes(t) for name, t in trees.items()},
    }


def record_memory(tel=None, *, phase: str = "mem", **trees):
    """Emit the memory snapshot as gauges on the run's event stream
    (``host_rss_bytes``, ``<tree>_bytes``, ``device_live_bytes`` /
    ``device_peak_bytes``).  Returns the snapshot, or None when telemetry
    is off (one registry read, nothing measured)."""
    tel = tel if tel is not None else telemetry.active()
    if tel is None:
        return None
    wm = memory_watermarks(**trees)
    tel.gauge("host_rss_bytes", wm["host_rss_bytes"], phase=phase)
    for name, nb in wm["trees"].items():
        tel.gauge(f"{name}_bytes", nb, phase=phase)
    if wm["devices"]:
        live = sum(d["live_bytes"] for d in wm["devices"].values())
        peak = sum(d["peak_bytes"] for d in wm["devices"].values())
        tel.gauge("device_live_bytes", live, phase=phase)
        tel.gauge("device_peak_bytes", peak, phase=phase)
    return wm


def program_key(key) -> str:
    """Stable short hash of a build key (a layout, a library's name): the
    identity compile spans are grouped by."""
    return hashlib.sha1(repr(key).encode()).hexdigest()[:12]


@contextlib.contextmanager
def compile_span(name: str, *, key=None, cache_size=None, tel=None,
                 **args):
    """Wrap a build point: times the block and emits a phase
    ``"compile"`` span tagged with the key's hash, plus a
    ``<name>_cache_size`` gauge when ``cache_size`` (a callable, evaluated
    after the build) is given.  The port has no compiled-program cache,
    so its build points pass none.  Telemetry off: one registry read, no
    timing, no records."""
    tel = tel if tel is not None else telemetry.active()
    if tel is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        span_args = dict(args)
        if key is not None:
            span_args["program"] = program_key(key)
        tel.span_at(name, t0, dur, phase="compile", **span_args)
        if cache_size is not None:
            try:
                tel.gauge(f"{name}_cache_size", float(cache_size()),
                          phase="compile")
            except Exception:
                pass


# ---------------------------------------------------------------------------
# declarative SLO rules

@dataclass
class SloRule:
    """One service-level objective over the event stream.

    ``metric`` names the record (span/gauge/hist/counter/event name);
    ``record`` its type, which fixes how a value is extracted: spans
    contribute their duration in milliseconds, gauges/hists their value,
    counters their increment, events 1.0 per occurrence.  ``agg`` folds
    the bounded window to one number (``spike`` delegates to
    metrics.SpikeDetector; ``age`` is seconds since the metric was last
    seen, where silence is the breach).  ``phase`` and ``rank`` narrow the
    match.  ``op``/``threshold`` judge the aggregate; ``severity`` is
    carried into breach events and hook decisions."""

    name: str
    metric: str
    threshold: float
    op: str = "<="
    window: int = 32
    agg: str = "p95"
    severity: str = "warn"
    phase: str | None = None
    rank: int | None = None
    record: str = "span"
    min_samples: int = 1
    spike_threshold: float = 10.0
    spike_min_history: int = 8

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"op {self.op!r} not in {OPS}")
        if self.agg not in AGGS:
            raise ValueError(f"agg {self.agg!r} not in {AGGS}")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {SEVERITIES}")
        if self.record not in RECORD_TYPES:
            raise ValueError(
                f"record {self.record!r} not in {RECORD_TYPES}")
        if self.window < 1:
            raise ValueError("window must be >= 1")

    def matches(self, rec: dict) -> bool:
        if rec.get("type") != self.record:
            # one rule, one record type
            return False
        if rec.get("name") != self.metric:
            return False
        if self.phase is not None and rec.get("phase") != self.phase:
            return False
        if self.rank is not None and rec.get("rank") != self.rank:
            return False
        return True

    def value_of(self, rec: dict) -> float | None:
        if self.record == "span":
            dur = rec.get("dur")
            return None if dur is None else float(dur) * 1e3  # -> ms
        if self.record in ("gauge", "hist"):
            v = rec.get("value")
            return None if not isinstance(v, (int, float)) else float(v)
        if self.record == "counter":
            v = rec.get("inc")
            return None if not isinstance(v, (int, float)) else float(v)
        return 1.0  # event: each occurrence counts once

    def to_dict(self) -> dict:
        return {
            "name": self.name, "metric": self.metric,
            "threshold": self.threshold, "op": self.op,
            "window": self.window, "agg": self.agg,
            "severity": self.severity, "phase": self.phase,
            "rank": self.rank, "record": self.record,
            "min_samples": self.min_samples,
            "spike_threshold": self.spike_threshold,
            "spike_min_history": self.spike_min_history,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SloRule":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__
                      if k in d})


@dataclass
class SloState:
    """Live evaluation state for one rule."""

    rule: SloRule
    window: deque = field(default_factory=deque)
    breached: bool = False
    breaches: int = 0
    samples: int = 0
    current: float | None = None
    last_value: float | None = None
    last_seen_mono: float | None = None
    detector: SpikeDetector | None = None

    def to_dict(self) -> dict:
        return {
            "rule": self.rule.to_dict(),
            "breached": self.breached,
            "breaches": self.breaches,
            "samples": self.samples,
            "current": self.current,
            "last_value": self.last_value,
            "window": list(self.window),
        }


def _aggregate(values: list[float], agg: str) -> float | None:
    if not values:
        return None
    if agg == "last":
        return values[-1]
    if agg == "mean":
        return sum(values) / len(values)
    if agg == "max":
        return max(values)
    if agg == "min":
        return min(values)
    s = sorted(values)
    q = 0.5 if agg == "p50" else 0.95
    return s[min(int(q * len(s)), len(s) - 1)]


class RunDoctor:
    """Online SLO evaluator over the record stream.

    Feed it live (``attach()`` subscribes to the process registry) or
    cross-process (``pump(RunTailer(run_dir))``); every observed record
    updates matching rules' bounded windows and, every ``check_every``
    observations, transitions are judged: entering breach emits an
    ``slo_breach`` event (phase ``"slo"``) and fires the registered
    breach hooks; leaving it emits ``slo_clear`` and fires clear hooks.
    Records of phase ``"slo"`` are ignored on input: the doctor's own
    events must not feed back into its windows."""

    def __init__(self, rules=(), *, check_every: int = 1, log=None):
        self.states: dict[str, SloState] = {}
        self.check_every = max(1, check_every)
        self.log = log
        self._hooks_breach: list = []
        self._hooks_clear: list = []
        self._attached: list = []
        self._since_check = 0
        self._checking = False
        self._t0_mono = time.perf_counter()
        for r in rules:
            self.add_rule(r)

    # -- wiring ----------------------------------------------------------
    def add_rule(self, rule: SloRule) -> SloState:
        if rule.name in self.states:
            raise ValueError(f"duplicate rule name {rule.name!r}")
        st = SloState(rule=rule, window=deque(maxlen=rule.window))
        if rule.agg == "spike":
            st.detector = SpikeDetector(
                window=max(rule.window, 2),
                threshold=rule.spike_threshold,
                min_history=rule.spike_min_history)
        self.states[rule.name] = st
        return st

    def on_breach(self, fn) -> None:
        """Register ``fn(state)`` for breach transitions."""
        self._hooks_breach.append(fn)

    def on_clear(self, fn) -> None:
        self._hooks_clear.append(fn)

    def attach(self, tel=None) -> bool:
        """Subscribe to the live registry (default: the active one)."""
        tel = tel if tel is not None else telemetry.active()
        if tel is None:
            return False
        tel.subscribe(self.observe)
        self._attached.append(tel)
        return True

    def detach(self) -> None:
        for tel in self._attached:
            try:
                tel.unsubscribe(self.observe)
            except Exception:
                pass
        self._attached = []

    # -- evaluation ------------------------------------------------------
    def observe(self, rec: dict) -> None:
        """Feed one record; auto-checks every ``check_every`` calls."""
        if rec.get("phase") == "slo":
            return  # never eat our own breach events
        hit = False
        for st in self.states.values():
            rule = st.rule
            if not rule.matches(rec):
                continue
            v = rule.value_of(rec)
            if v is None:
                continue
            hit = True
            st.samples += 1
            st.last_value = v
            st.last_seen_mono = time.perf_counter()
            if st.detector is not None:
                # SpikeDetector owns its window; a True return = spike
                st.window.append(1.0 if st.detector.update(v) else 0.0)
            else:
                st.window.append(v)
        if hit:
            self._since_check += 1
            if self._since_check >= self.check_every:
                self.check()

    def check(self, now: float | None = None) -> list[SloState]:
        """Judge every rule; returns states that TRANSITIONED.  Safe to
        call re-entrantly (a hook emitting records that re-trigger
        observe→check is a no-op inner call)."""
        if self._checking:
            return []
        self._checking = True
        self._since_check = 0
        flipped: list[SloState] = []
        try:
            now = now if now is not None else time.perf_counter()
            for st in self.states.values():
                rule = st.rule
                if rule.agg == "age":
                    base = (st.last_seen_mono if st.last_seen_mono
                            is not None else self._t0_mono)
                    cur = now - base
                elif rule.agg == "spike":
                    if len(st.window) < rule.min_samples:
                        continue
                    cur = sum(st.window)  # spikes in window
                else:
                    if len(st.window) < rule.min_samples:
                        continue
                    cur = _aggregate(list(st.window), rule.agg)
                if cur is None:
                    continue
                st.current = cur
                ok = (cur <= rule.threshold if rule.op == "<="
                      else cur >= rule.threshold)
                if not ok and not st.breached:
                    st.breached = True
                    st.breaches += 1
                    flipped.append(st)
                    self._emit("slo_breach", st)
                    self._fire(self._hooks_breach, st)
                elif ok and st.breached:
                    st.breached = False
                    flipped.append(st)
                    self._emit("slo_clear", st)
                    self._fire(self._hooks_clear, st)
        finally:
            self._checking = False
        return flipped

    def _emit(self, name: str, st: SloState) -> None:
        r = st.rule
        msg = (f"[monitor] {name}: {r.name} ({r.metric} {r.agg}="
               f"{st.current:.4g} {'>' if r.op == '<=' else '<'} "
               f"{r.threshold:g}, severity={r.severity})")
        log_line(msg)
        if self.log is not None:
            try:
                self.log(msg)
            except Exception:
                pass
        tel = telemetry.active()
        if tel is not None:
            tel.event(name, phase="slo", rule=r.name, metric=r.metric,
                      agg=r.agg, value=st.current,
                      threshold=r.threshold, op=r.op,
                      severity=r.severity, breaches=st.breaches,
                      rule_rank=r.rank)

    def _fire(self, hooks: list, st: SloState) -> None:
        for fn in hooks:
            try:
                fn(st)
            except Exception as e:  # a hook must never kill the doctor
                log_line(f"[monitor] hook {fn!r} failed: {e!r}")

    def pump(self, tailer: "RunTailer") -> int:
        """Drain a tailer into observe(); returns records consumed."""
        recs = tailer.poll()
        for rec in recs:
            self.observe(rec)
        return len(recs)

    def summary(self) -> dict:
        """Active SLO states keyed by rule name (the bundle's ``slo``
        section and the ``--slo`` table's source)."""
        return {name: st.to_dict() for name, st in self.states.items()}


class RunTailer:
    """Incremental reader over a run dir's ``events_*.jsonl`` files: the
    cross-process feed (a doctor in one process watching the workers).
    Tracks a byte offset per file and consumes only complete lines, so a
    torn tail mid-write is read whole on the next poll."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self._offsets: dict[str, int] = {}

    def poll(self) -> list[dict]:
        out: list[dict] = []
        try:
            names = sorted(os.listdir(self.run_dir))
        except OSError:
            return out
        for name in names:
            if not (name.startswith(telemetry.FILE_PREFIX)
                    and name.endswith(".jsonl")):
                continue
            path = os.path.join(self.run_dir, name)
            off = self._offsets.get(name, 0)
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read()
            except OSError:
                continue
            if not chunk:
                continue
            nl = chunk.rfind(b"\n")
            if nl < 0:
                continue  # only a torn line so far
            self._offsets[name] = off + nl + 1
            for line in chunk[:nl].split(b"\n"):
                if not line.strip():
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
        return out


# ---------------------------------------------------------------------------
# the wired hooks

def sentry_breach_hook(sentry, *, severity: str = "critical"):
    """Breach hook escalating through ``TrainingSentry``'s resize rung
    (utils/sentry.py): a breach at or above ``severity`` calls
    ``sentry.request_resize``, the rollback + ``on_resize`` + ladder reset
    the exhausted ladder takes, so an SLO breach and a loss-spike
    escalation recover the same way."""
    floor = SEVERITIES.index(severity)

    def hook(st: SloState) -> None:
        if SEVERITIES.index(st.rule.severity) < floor:
            return
        sentry.request_resize(f"slo:{st.rule.name}")
    return hook


# ---------------------------------------------------------------------------
# rule presets / serialization

def default_rules(*, step_ms_p95: float = 1000.0,
                  heartbeat_age_s: float = 300.0,
                  slot_utilization: float = 0.5,
                  fleet_handoff_ms: float = 5000.0,
                  device_peak_bytes: float | None = None) -> list[SloRule]:
    """The JAX package's four stock rules with overridable thresholds:
    the LM step's p95 (``lm_train_step`` spans, in ms), heartbeat age,
    mean slot utilization and the fleet handoff's p95.

    ``device_peak_bytes`` (None adds no rule) arms a device-memory
    watermark against the ``record_memory`` gauge of the same name."""
    rules = [
        SloRule(name="step_time", metric="lm_train_step",
                record="span", agg="p95", op="<=",
                threshold=step_ms_p95, severity="critical"),
        SloRule(name="heartbeat_fresh", metric="heartbeat",
                record="event", agg="age", op="<=",
                threshold=heartbeat_age_s, severity="critical"),
        SloRule(name="slot_utilization", metric="slot_utilization",
                record="gauge", agg="mean", op=">=",
                threshold=slot_utilization, severity="warn"),
        SloRule(name="fleet_handoff", metric="handoff_ms",
                record="hist", agg="p95", op="<=",
                threshold=fleet_handoff_ms, severity="warn",
                phase="fleet"),
    ]
    if device_peak_bytes is not None:
        rules.append(
            SloRule(name="device_memory_watermark",
                    metric="device_peak_bytes", record="gauge",
                    agg="max", op="<=", threshold=device_peak_bytes,
                    severity="critical"))
    return rules


def rules_from_json(path: str) -> list[SloRule]:
    with open(path) as f:
        raw = json.load(f)
    return [SloRule.from_dict(d) for d in raw]


def evaluate_run(run_dir: str, rules) -> dict:
    """Offline doctor pass over a finished (or live) run dir: the
    ``torch_telemetry_summary --slo`` path.  Replays every record in
    timestamp order through a fresh doctor; ``age`` rules are judged
    against the last record's timestamp, not the wall clock now (a
    finished run would otherwise always read stale)."""
    doctor = RunDoctor(rules, check_every=1)
    recs: list[tuple[float, dict]] = []
    for epoch, rows in telemetry.read_run(run_dir):
        for rec in rows:
            ts = rec.get("ts")
            if isinstance(ts, (int, float)):
                recs.append((telemetry._align_us(epoch, ts), rec))
    recs.sort(key=lambda p: p[0])
    if recs:
        # the never-seen fallback on the run's clock: a metric never seen
        # at all ages from the run's first record
        first_ts = recs[0][1].get("ts")
        if isinstance(first_ts, (int, float)):
            doctor._t0_mono = first_ts
    last_mono: float | None = None
    for _, rec in recs:
        doctor.observe(rec)
        ts = rec.get("ts")
        if isinstance(ts, (int, float)):
            last_mono = ts
    doctor.check(now=last_mono)
    return doctor.summary()


# ---------------------------------------------------------------------------
# flight recorder / postmortem bundles

def gang_from_env() -> dict:
    """Gang membership as the launcher env contract describes it from
    inside a worker; the agent passes its own view explicitly."""
    env = os.environ
    out = {}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "RESTART_ATTEMPT",
                "ELASTIC_MIN_WORKERS", "ELASTIC_MAX_WORKERS"):
        v = env.get(key)
        if v is not None:
            out[key.lower()] = v
    return out


def _ring_from_run_dir(run_dir: str, n: int) -> list[dict]:
    """Last-N records across the whole run dir (all ranks), ordered on
    the shared wall timeline the way merge_chrome_trace orders spans."""
    recs: list[tuple[float, dict]] = []
    for epoch, rows in telemetry.read_run(run_dir):
        for rec in rows:
            ts = rec.get("ts")
            if isinstance(ts, (int, float)):
                recs.append((telemetry._align_us(epoch, ts), rec))
    recs.sort(key=lambda p: p[0])
    return [r for _, r in recs[-n:]]


def write_postmortem(trigger: str, *, run_dir: str | None = None,
                     tel=None, detail: dict | None = None,
                     doctor: RunDoctor | None = None,
                     gang: dict | None = None,
                     serve_stats: dict | None = None,
                     memory: dict | None = None,
                     log_tail_n: int = 50,
                     ring_n: int = 256) -> str | None:
    """Write one postmortem bundle; returns its path, or None.

    Runs on the failure path (after a worker's death), so it never
    raises: any internal error returns None and the original failure
    handling proceeds.  The bundle is strict JSON (``_jsonsafe``: a
    diverging run's NaN stats are common here), written atomically (tmp +
    rename) so a reader racing the crash sees a whole bundle or none.
    """
    try:
        if trigger not in TRIGGERS:
            raise ValueError(f"trigger {trigger!r} not in {TRIGGERS}")
        tel = tel if tel is not None else telemetry.active()
        if run_dir is None:
            run_dir = tel.run_dir if tel is not None else None
        if run_dir is None:
            return None
        # flush our own registry first so the dir-wide ring includes
        # this process's newest records
        if tel is not None:
            try:
                tel.flush()
            except Exception:
                pass
        ring = _ring_from_run_dir(run_dir, ring_n)
        if not ring and tel is not None:
            ring = list(tel.recent)[-ring_n:]
        # trigger kind LAST: a detail dict carrying its own "kind"
        # (launch.py forwards worker-exit classifications verbatim)
        # must not shadow the bundle's trigger class
        trig = dict(detail or {})
        trig["kind"] = trigger
        bundle = {
            "version": BUNDLE_VERSION,
            "trigger": trig,
            "written_at": time.time(),
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "ring": ring,
            "slo": doctor.summary() if doctor is not None else {},
            "gang": gang if gang is not None else gang_from_env(),
            "serve": serve_stats or {},
            "memory": memory if memory is not None else
            memory_watermarks(),
            "log_tail": log_tail(log_tail_n),
        }
        os.makedirs(run_dir, exist_ok=True)
        name = (f"{BUNDLE_PREFIX}{trigger}_{os.getpid()}_"
                f"{int(time.time() * 1000)}.json")
        path = os.path.join(run_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(telemetry._jsonsafe(bundle), f)
        os.replace(tmp, path)
        log_line(f"[monitor] postmortem bundle written: {path}")
        if tel is not None:
            try:
                tel.event("postmortem", phase="slo", trigger=trigger,
                          path=path)
            except Exception:
                pass
        return path
    except Exception:
        return None


def _strict(value):  # json parse_constant hook
    raise ValueError(f"non-strict JSON constant {value!r}")


def load_postmortem(path: str) -> dict:
    """Parse + validate a bundle: STRICT json (any bare NaN/Infinity is
    a writer bug and raises), all schema keys present, a known trigger
    kind.  scripts/torch_postmortem.py and the tests share this validator."""
    with open(path) as f:
        bundle = json.load(f, parse_constant=_strict)
    missing = [k for k in BUNDLE_KEYS if k not in bundle]
    if missing:
        raise ValueError(f"bundle {path} missing keys {missing}")
    if bundle["version"] != BUNDLE_VERSION:
        raise ValueError(f"bundle version {bundle['version']!r} != "
                         f"{BUNDLE_VERSION}")
    kind = bundle["trigger"].get("kind")
    if kind not in TRIGGERS:
        raise ValueError(f"unknown trigger kind {kind!r}")
    return bundle


def find_postmortems(run_dir: str) -> list[str]:
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        return []
    return [os.path.join(run_dir, n) for n in names
            if n.startswith(BUNDLE_PREFIX) and n.endswith(".json")]


def format_postmortem(bundle: dict) -> str:
    """Human-readable rendering, shared by scripts/torch_postmortem.py and
    torch_telemetry_summary --postmortem."""
    trig = bundle["trigger"]
    lines = [
        f"postmortem: {trig.get('kind')}  (host {bundle['host']}, "
        f"pid {bundle['pid']})",
        "  written_at: " + time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime(bundle["written_at"])),
    ]
    extra = {k: v for k, v in trig.items() if k != "kind"}
    if extra:
        lines.append(f"  detail: {json.dumps(extra, sort_keys=True)}")
    gang = bundle.get("gang") or {}
    if gang:
        lines.append("  gang: " + ", ".join(
            f"{k}={v}" for k, v in sorted(gang.items())))
    mem = bundle.get("memory") or {}
    if mem:
        rss = mem.get("host_rss_bytes", 0)
        lines.append(f"  memory: host_rss={rss / 1e6:.1f} MB"
                     + "".join(f", {k}={v / 1e6:.1f} MB"
                               for k, v in sorted(
                                   (mem.get("trees") or {}).items())))
        for did, d in sorted((mem.get("devices") or {}).items()):
            lines.append(f"    device {did}: live="
                         f"{d['live_bytes'] / 1e6:.1f} MB peak="
                         f"{d['peak_bytes'] / 1e6:.1f} MB")
    slo = bundle.get("slo") or {}
    if slo:
        lines.append("  slo states:")
        for name, st in sorted(slo.items()):
            mark = "BREACHED" if st.get("breached") else "ok"
            cur = st.get("current")
            cur_s = f"{cur:.4g}" if isinstance(cur, (int, float)) else "-"
            rule = st.get("rule", {})
            lines.append(
                f"    {name:<24} {mark:<9} current={cur_s} "
                f"{rule.get('op', '?')} {rule.get('threshold', '?')} "
                f"(breaches={st.get('breaches', 0)}, "
                f"samples={st.get('samples', 0)})")
    serve = bundle.get("serve") or {}
    if serve:
        lines.append("  serve: " + json.dumps(serve, sort_keys=True))
    ring = bundle.get("ring") or []
    lines.append(f"  ring: {len(ring)} records")
    for rec in ring[-10:]:
        nm = rec.get("name", rec.get("type"))
        lines.append(f"    [{rec.get('phase', '?'):<8}] "
                     f"{rec.get('type', '?'):<8} {nm} "
                     f"rank={rec.get('rank')}")
    tail = bundle.get("log_tail") or []
    if tail:
        lines.append(f"  log tail ({len(tail)} lines):")
        lines.extend(f"    {ln}" for ln in tail[-10:])
    return "\n".join(lines)
