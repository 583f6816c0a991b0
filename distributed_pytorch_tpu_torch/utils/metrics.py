"""Training metrics with the reference's exact window semantics: the port of
``LossMeter``, ``IterTimeMeter`` and ``WindowRecord`` of the JAX package's
utils/metrics.py.

The reference's only observability is two printed windows (reference:
main.py:28-48, identical in every variant):

- running loss, averaged and reset every 20 iterations (main.py:40-42);
- per-iteration wall time, *excluding iteration 0* as warm-up, averaged and
  reset every 40 iterations — the first window therefore divides by 39,
  later windows by 40 (main.py:43-48).

The telemetry gauge the JAX meters emit per window comes with the telemetry
layer (ROADMAP.md queue 1, slice 5).
"""

from __future__ import annotations

from dataclasses import dataclass, field

LOSS_WINDOW = 20
TIME_WINDOW = 40


@dataclass
class WindowRecord:
    first_iter: int  # 1-based, matching the reference's printout
    last_iter: int
    value: float


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
            return rec
        return None
