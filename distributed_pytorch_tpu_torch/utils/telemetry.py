"""Run telemetry: one structured event stream for the whole port.

The port of the JAX package's utils/telemetry.py, record for record: the
record schema and the file names are the JAX package's, so either package's
exporter reads the other's run directories.

- **Registry** (``Telemetry``): counters, gauges, histogram-style
  observations, timed spans and discrete events, all in one record shape:
  ``{"type", "name", "phase", "ts", "rank", "gen", ...}``.  ``phase`` is the
  subsystem lane ("train", "serve", "gang", "compile", "mem", "slo"): the
  Chrome-trace ``tid``.
- **Sink**: one rank-tagged JSONL file per process under a shared run
  directory (``events_rank<R>_gen<G>_<pid><tag>.jsonl``).  Appends are whole
  lines written with a single ``os.write`` on an ``O_APPEND`` descriptor,
  and the default flushes every record, so a reader racing a live writer
  sees whole lines or nothing, and a worker that leaves through
  ``os._exit`` loses nothing.  The first record of every file is an
  **epoch** pinning (wall clock, monotonic clock), which is how the
  exporter aligns ranks that started at different times on one timeline.
- **Bounded memory**: a ring of the most recent ``ring`` records plus exact
  running aggregates per (phase, name).
- **Exporter**: ``merge_chrome_trace(run_dir)`` merges every rank's files
  into one Chrome-trace/Perfetto JSON (``pid`` = rank, ``tid`` = phase, the
  generation on every event), and ``run_summary(run_dir)`` is its
  machine-readable companion (``scripts/torch_telemetry_summary.py`` prints
  both).

**Off is the default and is free**: instrumented call sites guard on
``active()`` returning None (one module-global read), and the trainers
fetch nothing and launch nothing for telemetry while it is off.  The module
imports no torch: the launcher agent, which owns no device, logs gang
events through it.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import socket
import threading
import time
from collections import deque

# Env contract: the launcher exports the run directory to its workers
# (and the CLIs' --telemetry-dir defaults from it), so one flag on the
# agent wires the whole gang onto one timeline.
TELEMETRY_DIR_ENV = "TELEMETRY_DIR"
RECORD_VERSION = 1
FILE_PREFIX = "events_"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def _jsonsafe(obj):
    """Map non-finite floats to strings ("NaN"/"Infinity"/"-Infinity")
    recursively: Python's json module writes bare NaN, which is not strict
    JSON, and a diverging run gauges loss=NaN exactly when its trace
    matters most.  A 0-dim tensor or numpy scalar becomes its number (read
    by duck typing: this module imports no torch)."""
    if not isinstance(obj, (float, int, str, dict, list, tuple)) \
            and getattr(obj, "ndim", None) == 0 and hasattr(obj, "item"):
        obj = obj.item()
    if isinstance(obj, float):
        if obj != obj:
            return "NaN"
        if obj in (float("inf"), float("-inf")):
            return "Infinity" if obj > 0 else "-Infinity"
        return obj
    if isinstance(obj, dict):
        return {k: _jsonsafe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonsafe(v) for v in obj]
    return obj


class Telemetry:
    """One process's telemetry registry + JSONL sink.

    ``rank``/``gen`` default from the launcher env contract (``RANK``,
    ``RESTART_ATTEMPT``); the agent itself registers as rank -1 with
    ``label="agent"``.  All methods are thread-safe (the serving loop and
    its helper threads share the process registry).
    """

    def __init__(self, run_dir: str, *, rank: int | None = None,
                 gen: int | None = None, ring: int = 4096,
                 flush_every: int = 1, label: str | None = None,
                 tag: str = ""):
        self.run_dir = run_dir
        self.rank = rank if rank is not None else _env_int("RANK", 0)
        self.gen = (gen if gen is not None
                    else _env_int("RESTART_ATTEMPT", 0))
        self.label = label
        self.flush_every = max(1, flush_every)
        os.makedirs(run_dir, exist_ok=True)
        # ``tag`` tells apart several registries of one process writing
        # the same run_dir (each under its own rank in the merged trace):
        # without it two same-rank registries would interleave epochs in
        # one O_APPEND file
        self.path = os.path.join(
            run_dir,
            f"{FILE_PREFIX}rank{self.rank}_gen{self.gen}_"
            f"{os.getpid()}{tag}.jsonl")
        self._lock = threading.Lock()
        self._fd: int | None = None
        self._pending: list[str] = []
        self._closed = False
        # bounded in-memory view: recent records for summaries/debugging,
        # exact running aggregates forever
        self.recent: deque[dict] = deque(maxlen=ring)
        self._counters: dict[tuple[str, str], float] = {}
        self._gauges: dict[tuple[str, str], float] = {}
        self._spans: dict[tuple[str, str], list] = {}  # [n, total, max]
        self._events: dict[tuple[str, str], int] = {}
        # live-record subscribers (the run doctor): called outside the
        # lock, since a subscriber may emit its own records (breach
        # events) and the lock is not reentrant
        self._subs: list = []
        # keep one bound-method object: atexit.unregister matches the
        # registered callable, and `self.close` is a fresh bound method on
        # every access
        self._atexit_hook = self.close
        atexit.register(self._atexit_hook)

    # -- sink --------------------------------------------------------------
    def _open(self) -> int:
        """Open the sink lazily and stamp the EPOCH record first: wall +
        monotonic clock pinned at the same instant, which is what lets
        the exporter place this process's monotonic timestamps on the
        shared wall timeline."""
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                     0o644)
        epoch = {"type": "epoch", "version": RECORD_VERSION,
                 "rank": self.rank, "gen": self.gen, "pid": os.getpid(),
                 "host": socket.gethostname(), "label": self.label,
                 "wall": time.time(), "mono": time.perf_counter()}
        os.write(fd, (json.dumps(epoch) + "\n").encode())
        return fd

    def _record(self, rec: dict) -> None:
        rec = _jsonsafe(rec)  # strict JSON even for NaN/Inf gauges
        with self._lock:
            if self._closed:
                return
            self.recent.append(rec)
            self._pending.append(json.dumps(rec))
            if len(self._pending) >= self.flush_every:
                self._flush_locked()
            subs = self._subs if self._subs else None
        if subs:
            # snapshot taken under the lock; delivery outside it so a
            # subscriber may emit records (breach events) without
            # deadlocking on the non-reentrant lock
            for fn in subs:
                try:
                    fn(rec)
                except Exception:
                    pass  # a broken monitor must never break the run

    def subscribe(self, fn) -> None:
        """Register ``fn(record_dict)`` to see every record as it lands
        (the run doctor's live feed).  No subscribers (the default) costs
        one truthiness test per record."""
        with self._lock:
            if fn not in self._subs:
                self._subs = self._subs + [fn]

    def unsubscribe(self, fn) -> None:
        """Drop ``fn``, compared by equality as ``subscribe`` compares it:
        a bound method (``doctor.observe``) is a new object at every
        access, so an identity test would never find it."""
        with self._lock:
            self._subs = [s for s in self._subs if s != fn]

    def _flush_locked(self) -> None:
        if not self._pending:
            return
        if self._fd is None:
            self._fd = self._open()
        data = ("\n".join(self._pending) + "\n").encode()
        self._pending = []
        # one write on an O_APPEND descriptor: a reader (the exporter,
        # possibly racing a live run) sees whole lines or nothing
        os.write(self._fd, data)

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._flush_locked()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None
            self._closed = True
        # drop the exit hook: a process that cycles enable()/disable()
        # must not pin one dead registry per cycle on the atexit list
        try:
            atexit.unregister(self._atexit_hook)
        except Exception:
            pass

    # -- instruments -------------------------------------------------------
    def _base(self, type_: str, name: str, phase: str) -> dict:
        return {"type": type_, "name": name, "phase": phase,
                "ts": time.perf_counter(), "rank": self.rank,
                "gen": self.gen}

    def counter(self, name: str, inc: float = 1, *, phase: str = "run",
                **args) -> None:
        """Monotonic accumulator; the record carries both the increment
        and the running total (so a truncated stream still reads)."""
        key = (phase, name)
        with self._lock:
            total = self._counters[key] = self._counters.get(key, 0) + inc
        rec = self._base("counter", name, phase)
        rec["inc"] = inc
        rec["total"] = total
        if args:
            rec["args"] = args
        self._record(rec)

    def gauge(self, name: str, value: float, *, phase: str = "run",
              **args) -> None:
        """Point-in-time scalar (loss, grad-norm, window average)."""
        with self._lock:
            self._gauges[(phase, name)] = value
        rec = self._base("gauge", name, phase)
        rec["value"] = value
        if args:
            rec["args"] = args
        self._record(rec)

    def observe(self, name: str, value: float, *, phase: str = "run",
                **args) -> None:
        """Histogram-style observation: aggregated like a span's
        duration (count/total/max + the recent ring for percentiles)."""
        self._span_agg((phase, name), value)
        rec = self._base("hist", name, phase)
        rec["value"] = value
        if args:
            rec["args"] = args
        self._record(rec)

    def event(self, name: str, *, phase: str = "run", **args) -> None:
        """Discrete occurrence (a worker's start or exit, a breach)."""
        key = (phase, name)
        with self._lock:
            self._events[key] = self._events.get(key, 0) + 1
        rec = self._base("event", name, phase)
        rec["args"] = args
        self._record(rec)

    def _span_agg(self, key: tuple, dur: float) -> None:
        with self._lock:
            agg = self._spans.get(key)
            if agg is None:
                agg = self._spans[key] = [0, 0.0, 0.0]
            agg[0] += 1
            agg[1] += dur
            agg[2] = max(agg[2], dur)

    def span_at(self, name: str, start: float, dur: float, *,
                phase: str = "run", **args) -> None:
        """Record a completed span from a caller-held ``perf_counter``
        pair: the hot-loop entry point (PhaseTimer.add's shape).  The
        duration is host time: on the eager port a step's span is its
        dispatch on the host, not the device's time for it."""
        self._span_agg((phase, name), dur)
        rec = {"type": "span", "name": name, "phase": phase, "ts": start,
               "dur": dur, "rank": self.rank, "gen": self.gen}
        if args:
            rec["args"] = args
        self._record(rec)

    @contextlib.contextmanager
    def span(self, name: str, *, phase: str = "run", **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.span_at(name, t0, time.perf_counter() - t0, phase=phase,
                         **args)

    # -- in-process view ---------------------------------------------------
    def summary(self) -> dict:
        """Exact running aggregates (counters' totals, gauges' last
        values, span/hist count-total-max, event counts), keyed
        "phase/name".  Percentiles come from the run files; this is the
        bounded in-memory view."""
        with self._lock:
            return {
                "rank": self.rank, "gen": self.gen,
                "counters": {f"{p}/{n}": v
                             for (p, n), v in self._counters.items()},
                "gauges": {f"{p}/{n}": v
                           for (p, n), v in self._gauges.items()},
                "spans": {f"{p}/{n}": {"count": a[0], "total_s": a[1],
                                       "max_s": a[2]}
                          for (p, n), a in self._spans.items()},
                "events": {f"{p}/{n}": v
                           for (p, n), v in self._events.items()},
            }


# ---------------------------------------------------------------------------
# process-wide registry (the no-op fast path when disabled)

_ACTIVE: Telemetry | None = None


def active() -> Telemetry | None:
    """The process registry, or None when telemetry is off (the default).
    Call sites guard on this: one module-global read on the off path."""
    return _ACTIVE


def enable(run_dir: str, **kwargs) -> Telemetry:
    """Install the process registry writing into ``run_dir``; replaces
    (and closes) a previous registry."""
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.close()
    _ACTIVE = Telemetry(run_dir, **kwargs)
    return _ACTIVE


def maybe_enable(run_dir: str | None = None, **kwargs) -> Telemetry | None:
    """Enable iff a run directory is known: the explicit argument (a
    CLI's --telemetry-dir) or the launcher-exported ``TELEMETRY_DIR``;
    None otherwise (off by default)."""
    run_dir = run_dir or os.environ.get(TELEMETRY_DIR_ENV)
    if not run_dir:
        return None
    return enable(run_dir, **kwargs)


def child_env(tel: Telemetry | None = None) -> dict[str, str]:
    """The env contract that hands this process's run directory to a
    child process: merged into the child's environment, its
    ``maybe_enable()`` lands in the same run dir, so the per-process event
    files (pid-suffixed) merge into one Chrome trace.  An empty dict when
    telemetry is off, safe to splat unconditionally."""
    tel = tel if tel is not None else active()
    run_dir = tel.run_dir if tel is not None else os.environ.get(
        TELEMETRY_DIR_ENV)
    return {TELEMETRY_DIR_ENV: run_dir} if run_dir else {}


def enable_from_cli(run_dir: str | None = None) -> Telemetry | None:
    """The CLIs' bootstrap (cli.py / lm_cli.py): ``maybe_enable`` with
    the rank of ``utils.logging.current_rank``, the resolver that stamps
    log lines (env ``RANK``, then the initialised default process group's
    rank, then 0), so telemetry and logs never disagree on a rank; neither
    imports torch."""
    from .logging import current_rank

    return maybe_enable(run_dir, rank=current_rank())


def disable() -> None:
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.close()
    _ACTIVE = None


def emit_train_steps(tel: Telemetry, t0: float, step0: int, k: int,
                     losses, oks, mets, *, span_name: str = "train_steps",
                     phase: str = "train") -> None:
    """The train-dispatch emission both trainers share (train.py /
    lm.py): a span for the dispatch, per-step gauges of the step's
    scalars (loss, gradient global norm, post-update param global norm)
    and an event for any unhealthy step.  ``losses``, ``oks`` and
    ``mets`` are host arrays (the trainers fetch them in one copy a
    dispatch, ``utils.tracing.host_scalars``); only ever called with an
    active registry, so telemetry off fetches nothing.  The span's
    duration is taken before anything here runs: host dispatch time.
    numpy imports lazily: the launcher agent imports this module."""
    import numpy as np

    dur = time.perf_counter() - t0
    step0, k = int(step0), int(k)
    losses = np.asarray(losses).reshape(-1)
    oks = np.asarray(oks).reshape(-1)
    mets = np.asarray(mets).reshape(-1, 2)
    tel.span_at(span_name, t0, dur, phase=phase, step0=step0, k=k)
    for i in range(k):
        s = step0 + i
        tel.gauge("loss", float(losses[i]), phase=phase, step=s)
        tel.gauge("grad_norm", float(mets[i, 0]), phase=phase, step=s)
        tel.gauge("param_norm", float(mets[i, 1]), phase=phase, step=s)
        if float(oks[i]) < 1.0:
            tel.event("unhealthy_step", phase=phase, step=s,
                      ok=float(oks[i]))
    tel.counter("steps", k, phase=phase)


def emit_sync_windows(tel: Telemetry, t0: float, step0: int, k: int,
                      sync_every: int, *, wire_bytes: int | None = None,
                      span_name: str = "sync_window",
                      phase: str = "train") -> None:
    """Window-boundary spans and per-window wire gauges of a
    ``sync_every > 1`` dispatch: one ``sync_window`` span per completed
    H-step window inside it, stamped with its step range, and a
    ``window_wire_bytes`` gauge (the trainer's static float32 estimate
    of one boundary exchange's payload; compression sends less).  The
    dispatch is one host measurement, so the window spans split its
    duration evenly: the timeline shows the boundaries' cadence, not
    each window's jitter."""
    windows = k // sync_every
    if windows <= 0:
        return
    dur = (time.perf_counter() - t0) / windows
    for w in range(windows):
        tel.span_at(span_name, t0 + w * dur, dur, phase=phase,
                    step0=int(step0) + w * sync_every, k=sync_every)
        if wire_bytes is not None:
            tel.gauge("window_wire_bytes", float(wire_bytes), phase=phase,
                      step=int(step0) + (w + 1) * sync_every - 1)
    tel.counter("sync_windows", windows, phase=phase)


def emit_window_plan(tel: Telemetry, *, step: int,
                     sync_every_per_slice=None,
                     outer_steps: int | None = None,
                     phase: str = "train") -> None:
    """Boundary gauges of the outer-optimizer windows: one
    ``sync_every_slice{i}`` gauge per slice under
    ``sync_every_per_slice``, and an ``outer_opt_steps`` gauge counting
    the outer steps applied.  Each is skipped when its feature is off."""
    if sync_every_per_slice is not None:
        for i, h in enumerate(sync_every_per_slice):
            tel.gauge(f"sync_every_slice{i}", float(h), phase=phase,
                      step=int(step))
    if outer_steps is not None:
        tel.gauge("outer_opt_steps", float(outer_steps), phase=phase,
                  step=int(step))


# ---------------------------------------------------------------------------
# exporter: merge every rank's files -> Chrome trace + run summary


def read_run(run_dir: str) -> list[tuple[dict, list[dict]]]:
    """Parse every per-process event file in ``run_dir`` into
    ``(epoch_record, records)`` pairs.  Torn trailing lines (a reader
    racing a live writer) and unreadable files are skipped: the merge
    works mid-run."""
    out = []
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(FILE_PREFIX) and name.endswith(".jsonl")):
            continue
        epoch, records = None, []
        try:
            with open(os.path.join(run_dir, name)) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail of a live file
                    if rec.get("type") == "epoch":
                        epoch = rec
                    else:
                        records.append(rec)
        except OSError:
            continue
        if epoch is not None:
            out.append((epoch, records))
    # chronological by each file's epoch wall clock, not by file name:
    # lexicographic order puts gen10 before gen2
    out.sort(key=lambda pair: pair[0].get("wall", 0.0))
    return out


def _align_us(epoch: dict, mono_ts: float) -> float:
    """Monotonic timestamp -> shared wall-clock microseconds, via the
    file's epoch record (wall and mono pinned at the same instant)."""
    return (epoch["wall"] + (mono_ts - epoch["mono"])) * 1e6


def merge_chrome_trace(run_dir: str) -> dict:
    """Merge all ranks' event files into one Chrome-trace/Perfetto JSON:
    ``pid`` = rank (process-named, the agent's -1 reads "agent"),
    ``tid`` = phase, spans as complete ("X") events, discrete events as
    instants, counters/gauges as counter ("C") tracks; every event's
    args carry its generation, so a timeline over restarts stays
    attributable."""
    events: list[dict] = []
    seen_pids: set[int] = set()
    for epoch, records in read_run(run_dir):
        pid = int(epoch["rank"])
        if pid not in seen_pids:
            seen_pids.add(pid)
            name = (epoch.get("label")
                    or ("agent" if pid < 0 else f"rank {pid}"))
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": name}})
            events.append({"ph": "M", "name": "process_sort_index",
                           "pid": pid, "tid": 0,
                           "args": {"sort_index": pid}})
        for rec in records:
            ts = _align_us(epoch, rec["ts"])
            args = dict(rec.get("args") or {})
            # a caller-supplied generation wins (the agent's registry is
            # pinned gen 0 but its events span every generation: launch.py
            # _tel_event); the registry gen is the default
            args.setdefault("gen", rec.get("gen", epoch.get("gen", 0)))
            kind = rec.get("type")
            base = {"name": rec.get("name", "?"), "pid": pid,
                    "tid": rec.get("phase", "run"), "ts": ts}
            if kind == "span":
                events.append(dict(base, ph="X",
                                   dur=rec.get("dur", 0.0) * 1e6,
                                   args=args))
            elif kind in ("counter", "gauge", "hist"):
                value = rec.get("total", rec.get("value", 0))
                events.append(dict(base, ph="C",
                                   args={rec.get("name", "?"): value}))
            else:  # event (and any forward-compat record type)
                for k in ("inc", "total", "value"):
                    if k in rec:
                        args[k] = rec[k]
                events.append(dict(base, ph="i", s="p", args=args))
    events.sort(key=lambda e: (e.get("ts", 0), e["pid"]))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"run_dir": os.path.abspath(run_dir),
                          "record_version": RECORD_VERSION}}


def _percentiles(values: list[float]) -> dict:
    s = sorted(values)
    n = len(s)
    return {"count": n, "total_s": sum(s), "p50_s": s[n // 2],
            "p95_s": s[min(n - 1, int(n * 0.95))], "max_s": s[-1]}


def run_summary(run_dir: str) -> dict:
    """Machine-readable cross-rank rollup of a run directory:

    - ``spans``: per (rank, phase, name) duration percentiles;
    - ``counters``: per (rank, phase, name) final totals;
    - ``gauges``: per (rank, phase, name) last value + count;
    - ``events``: per (rank, phase, name) occurrence counts, with the
      per-generation breakdown;
    - ``ranks`` / ``generations``: which processes contributed.
    """
    spans: dict[str, list[float]] = {}
    counters: dict[str, float] = {}
    gauges: dict[str, dict] = {}
    events: dict[str, dict] = {}
    ranks: set[int] = set()
    gens: set[int] = set()
    for epoch, records in read_run(run_dir):
        ranks.add(int(epoch["rank"]))
        gens.add(int(epoch.get("gen", 0)))
        for rec in records:
            key = (f"rank{rec.get('rank', epoch['rank'])}/"
                   f"{rec.get('phase', 'run')}/{rec.get('name', '?')}")
            # a caller-supplied args gen wins over the registry's (the
            # agent's events span generations its registry does not)
            rec_gen = (rec.get("args") or {}).get(
                "gen", rec.get("gen", epoch.get("gen", 0)))
            gens.add(int(rec_gen))
            kind = rec.get("type")
            if kind == "span":
                spans.setdefault(key, []).append(rec.get("dur", 0.0))
            elif kind == "counter":
                # sum the increments: running totals restart at zero in
                # every new registry (a respawn writes a new file; a
                # re-enable appends to the same file), so neither a
                # per-file max nor the last total is the run's count
                counters[key] = counters.get(key, 0) + rec.get("inc", 0)
            elif kind in ("gauge", "hist"):
                g = gauges.setdefault(key, {"count": 0, "last": None})
                g["count"] += 1
                g["last"] = rec.get("value")
            else:
                e = events.setdefault(key, {"count": 0, "by_gen": {}})
                e["count"] += 1
                g = str(rec_gen)
                e["by_gen"][g] = e["by_gen"].get(g, 0) + 1
    return {
        "ranks": sorted(ranks), "generations": sorted(gens),
        "spans": {k: _percentiles(v) for k, v in sorted(spans.items())},
        "counters": dict(sorted(counters.items())),
        "gauges": dict(sorted(gauges.items())),
        "events": dict(sorted(events.items())),
    }
