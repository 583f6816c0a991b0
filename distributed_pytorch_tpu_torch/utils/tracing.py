"""Profiling and tracing: the port of the JAX package's utils/tracing.py.

- ``trace(log_dir)``: a ``torch.profiler`` capture (host operators and, on
  the card, its kernels and copies) of the enclosed region, written into
  ``log_dir`` as a Chrome trace (``<host>_<pid>.<n>.pt.trace.json``, which
  TensorBoard's profiler plugin and https://ui.perfetto.dev load) on exit;
- ``annotate_step(n)``: a named range marking one training step in an
  active trace (a ``record_function``; near free with no profiler on);
- ``StepTimer``: wall-clock step timing with a percentile summary;
- ``PhaseTimer``: named-phase wall-clock accumulation (serve.py's plan /
  dispatch / fetch / parse attribution), each segment also re-emitted as a
  span on the telemetry stream when it is on;
- ``lazy_host``: several small device tensors fetched in one copy (the
  trainers' per-dispatch telemetry scalars).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from . import telemetry


def _activities() -> list:
    from torch.profiler import ProfilerActivity
    wanted = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        wanted.append(ProfilerActivity.CUDA)
    return wanted


# Seconds a GPU session waits, after its device sync, before it stops:
# the device's records of the last kernels reach the profiler after the
# kernels end, and those not there at the stop are lost (the last 18-89
# records of 5 LM-base steps in 2 of 6 sessions stopped at once, none in 6
# after 0.2 s: scripts/observability_probe.py --loss).
RECORDS_SETTLE_S = 0.5


def start_profile(activities=None, on_trace_ready=None):
    """A started ``torch.profiler`` session that records from the moment
    it returns (CPU and, on a GPU, CUDA activity by default).  On a GPU it
    first runs one warm-up cycle, collecting and discarding, over a burst
    of small kernels: kernel records at the very start of a session were
    seen missing from its trace (the first ~70 of a training step, late in
    a long process; the warm-up makes that rarer, it does not rule it
    out).  ``stop_profile`` ends it (and calls ``on_trace_ready``)."""
    from torch.profiler import profile, schedule
    prof = profile(activities=activities or _activities(),
                   schedule=schedule(wait=0, warmup=1, active=1),
                   on_trace_ready=on_trace_ready)
    prof.start()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        x = torch.zeros(1024, device=torch.cuda.current_device())
        for _ in range(256):
            x.add_(1.0)
        torch.cuda.synchronize()
    prof.step()
    return prof


def stop_profile(prof) -> None:
    """End a ``start_profile`` session with every record of the work it
    saw: on a GPU, synchronise the device and wait ``RECORDS_SETTLE_S`` for
    the last kernels' records, then stop."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        time.sleep(RECORDS_SETTLE_S)
    prof.stop()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region (CPU operators, and the CUDA kernels and
    copies on a GPU; ``start_profile``) and write its Chrome trace into
    ``log_dir`` on exit, through ``stop_profile``, so the trace holds the
    records of every kernel the region launched."""
    from torch.profiler import tensorboard_trace_handler
    prof = start_profile(on_trace_ready=tensorboard_trace_handler(log_dir))
    try:
        yield prof
    finally:
        stop_profile(prof)


def annotate_step(step: int):
    """Context manager marking one train step in an active trace."""
    return torch.profiler.record_function(f"train_step#{step}")


class _Fetch:
    """The tensors of one ``lazy_host`` call, copied to the host together
    at the first read: one concatenation on their device and one copy,
    each part flattened to float32."""

    def __init__(self, tensors):
        self.tensors, self.host = tensors, None

    def part(self, i: int) -> np.ndarray:
        if self.host is None:
            parts = [torch.as_tensor(t).detach().reshape(-1).float()
                     for t in self.tensors]
            flat = torch.cat(parts).cpu().numpy()
            ends = np.cumsum([p.numel() for p in parts])
            self.host = np.split(flat, ends[:-1])
            self.tensors = None
        return self.host[i]


class _HostView:
    """An array-like whose first ``np.asarray`` makes its ``_Fetch``'s one
    copy."""

    def __init__(self, fetch: _Fetch, i: int):
        self._fetch, self._i = fetch, i

    def __array__(self, dtype=None, copy=None):
        a = self._fetch.part(self._i)
        return a if dtype is None else a.astype(dtype)


def lazy_host(*tensors) -> tuple:
    """Array-likes of ``tensors`` that copy all of them to the host in one
    go when the first is read (``np.asarray``): the telemetry emitters
    take a step's duration before they read the scalars, so the span
    measures the host's dispatch, not the fetch."""
    fetch = _Fetch(tensors)
    return tuple(_HostView(fetch, i) for i in range(len(tensors)))


@dataclass
class StepTimer:
    """Wall-clock step timer with summary stats (excludes warm-up steps,
    like the reference's iteration-0 exclusion at main.py:43-48)."""

    skip_first: int = 1
    _times: list[float] = field(default_factory=list)
    _seen: int = 0
    _t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.skip_first:
            self._times.append(dt)
        return False

    def summary(self) -> dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[min(n - 1, int(n * 0.9))],
            "max_s": ts[-1],
        }


@dataclass
class PhaseTimer:
    """Wall-clock accumulation by NAMED PHASE.

    ``phase(name)`` is a context manager around a code region; ``add(name,
    seconds)`` takes a ``perf_counter`` delta the caller already holds.
    Exact running aggregates (count / total / max) are kept per phase; the
    percentile window holds only the most recent ``window`` segments, so a
    long-lived server's memory stays bounded.  ``enabled=False`` turns the
    timer into a no-op.  With the telemetry registry on, every segment is
    also a span in the ``component`` lane of the stream (one registry read
    a segment while it is off).
    """

    enabled: bool = True
    window: int = 4096
    component: str = "serve"
    _recent: dict = field(default_factory=dict)   # phase -> deque[float]
    _agg: dict = field(default_factory=dict)      # phase -> [n, total, max]

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        if not self.enabled:
            return
        agg = self._agg.get(name)
        if agg is None:
            agg = self._agg[name] = [0, 0.0, 0.0]
            self._recent[name] = deque(maxlen=self.window)
        agg[0] += 1
        agg[1] += seconds
        agg[2] = max(agg[2], seconds)
        self._recent[name].append(seconds)
        tel = telemetry.active()
        if tel is not None:
            # the segment just ended: its start is now less its length
            tel.span_at(name, time.perf_counter() - seconds, seconds,
                        phase=self.component)

    def reset(self) -> None:
        self._recent.clear()
        self._agg.clear()

    def summary(self) -> dict[str, dict[str, float]]:
        """phase -> {segments, total_s, p50_s, p95_s, max_s}, plus a
        ``"_total_s"`` key summing every phase."""
        out: dict = {}
        total = 0.0
        for name, (n, tot, mx) in self._agg.items():
            s = sorted(self._recent[name])
            m = len(s)
            total += tot
            out[name] = {
                "segments": n,
                "total_s": tot,
                "p50_s": s[m // 2] if m else 0.0,
                "p95_s": s[min(m - 1, int(0.95 * m))] if m else 0.0,
                "max_s": mx,
            }
        out["_total_s"] = total
        return out
