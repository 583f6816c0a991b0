"""Training metrics with the reference's exact window semantics: the port of
``LossMeter``, ``IterTimeMeter`` and ``WindowRecord`` of the JAX package's
utils/metrics.py.

The reference's only observability is two printed windows (reference:
main.py:28-48, identical in every variant):

- running loss, averaged and reset every 20 iterations (main.py:40-42);
- per-iteration wall time, *excluding iteration 0* as warm-up, averaged and
  reset every 40 iterations — the first window therefore divides by 39,
  later windows by 40 (main.py:43-48).

Each completed window also lands as a gauge on the run's telemetry stream
when it is on (``window_loss``, ``window_iter_seconds``).  ``SpikeDetector``
is the run doctor's ``spike`` test (utils/monitor.py).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

from . import telemetry

LOSS_WINDOW = 20
TIME_WINDOW = 40


@dataclass
class WindowRecord:
    first_iter: int  # 1-based, matching the reference's printout
    last_iter: int
    value: float


def _window_gauge(name: str, rec: WindowRecord) -> None:
    """A completed window as a gauge on the telemetry stream, the value
    the meter prints; free while telemetry is off."""
    tel = telemetry.active()
    if tel is not None:
        tel.gauge(name, rec.value, phase="train",
                  first_iter=rec.first_iter, last_iter=rec.last_iter)


@dataclass
class LossMeter:
    """Running loss averaged per 20-iteration window (main.py:40-42)."""

    window: int = LOSS_WINDOW
    running: float = 0.0
    records: list[WindowRecord] = field(default_factory=list)

    def update(self, batch_idx: int, loss: float) -> WindowRecord | None:
        self.running += loss
        if batch_idx % self.window == self.window - 1:
            rec = WindowRecord(batch_idx - self.window + 2, batch_idx + 1,
                               self.running / self.window)
            self.records.append(rec)
            self.running = 0.0
            _window_gauge("window_loss", rec)
            return rec
        return None


@dataclass
class IterTimeMeter:
    """Avg s/iter per 40-iteration window, iteration 0 excluded
    (main.py:43-48): iteration 0's time is never counted, and the first
    window is divided by 39 while all later ones divide by 40."""

    window: int = TIME_WINDOW
    total: float = 0.0
    records: list[WindowRecord] = field(default_factory=list)

    def update(self, batch_idx: int, seconds: float) -> WindowRecord | None:
        if batch_idx != 0:
            self.total += seconds
        if batch_idx % self.window == self.window - 1:
            divisor = self.window - 1 if batch_idx == self.window - 1 \
                else self.window
            rec = WindowRecord(batch_idx - divisor + 2, batch_idx + 1,
                               self.total / divisor)
            self.records.append(rec)
            self.total = 0.0
            _window_gauge("window_iter_seconds", rec)
            return rec
        return None


class SpikeDetector:
    """Rolling median/MAD outlier detector (the JAX package's, the run
    doctor's ``spike`` aggregation).

    A value spikes when it exceeds ``median + threshold * sigma`` of the
    trailing window, sigma being the MAD scaled to a normal-consistent
    estimate (1.4826 * MAD) floored by ``min_sigma``, so a near-constant
    stream (MAD 0) does not flag ordinary noise.  Median and MAD rather than
    mean and deviation, so one huge value barely moves the baseline it is
    judged against.  Non-finite values always spike.  Spiking values are
    not admitted to the window; the first ``min_history`` values train the
    baseline and never spike."""

    def __init__(self, window: int = 32, threshold: float = 10.0,
                 min_history: int = 8, min_sigma: float = 1e-3):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.window = window
        self.threshold = threshold
        self.min_history = max(min_history, 2)
        self.min_sigma = min_sigma
        self._hist: deque[float] = deque(maxlen=window)

    def _median(self, values: list[float]) -> float:
        s = sorted(values)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def bound(self) -> float:
        """The current spike threshold (+inf while the baseline trains)."""
        if len(self._hist) < self.min_history:
            return math.inf
        vals = list(self._hist)
        med = self._median(vals)
        mad = self._median([abs(v - med) for v in vals])
        sigma = max(1.4826 * mad, self.min_sigma)
        return med + self.threshold * sigma

    def update(self, value: float) -> bool:
        """Feed one value; True means a spike (kept out of the window)."""
        if not math.isfinite(value):
            return True
        if value > self.bound():
            return True
        self._hist.append(value)
        return False
