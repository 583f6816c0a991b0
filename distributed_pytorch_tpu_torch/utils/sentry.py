"""Training sentry: detect bad steps, roll back, skip, escalate.  The port of
the JAX package's utils/sentry.py.

The sentry is the host-side recovery loop over the per-step health
signals the trainers already compute (``last_ok``: loss and gradient sum
of squares finite):

1. **Detect**: a step is bad when its health flag trips or its loss
   exceeds the rolling median/MAD spike bound (``metrics.SpikeDetector``).
2. **Rewind and skip**: restore the last-good snapshot (host copies of
   the state and the step counter) and DROP the data window since it: the
   caller goes on with the next batch, so the offending window is never
   replayed, and since the step counter rewinds with the state the
   trajectory after the rollback is bitwise the one of a clean run over
   the same data with the window left out.
3. **Escalate**: triggers inside one recovery horizon climb a ladder:
   skip the window (level <= ``skip_budget``); then also tighten the
   gradient clip through the trainer's ``tighten_grad_clip`` by
   ``clip_factor`` a level; past ``max_rollbacks``, with an ``on_resize``
   hook installed, roll back once more and request a gang resize (the
   hook returns True when it resized in-process); only past that does the
   sentry write a ``sentry_abort`` postmortem and raise ``SentryAbort``.
   ``checkpoint_every`` clean steps take a new snapshot and reset the
   ladder.

``self.stats`` counts the events (steps, nonfinite, spikes, rollbacks,
skipped_steps, clip_tightened, stragglers, snapshots, resizes); a second
SpikeDetector over step wall times counts stragglers, never rolled back.

The snapshot holds the reference's set: whichever of ``params``,
``state``, ``opt_state`` and ``sync_state`` the trainer has, and
``_step``.  The port's VGG trainer exposes its SGD momentum buffers as
``opt_state`` (a buffer that did not exist at the snapshot is put back to
none).  An LM sync window's delta is not in the set, as in the reference.
The rollback copies the snapshot into the live tensors in place (the VGG
optimizer holds its params by reference).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from . import monitor, telemetry
from .metrics import SpikeDetector


def _tel_event(name: str, **args) -> None:
    """Sentry escalations as events in the 'sentry' lane when telemetry is
    on; free otherwise."""
    tel = telemetry.active()
    if tel is not None:
        tel.event(name, phase="sentry", **args)


@dataclass
class SentryConfig:
    checkpoint_every: int = 50   # clean steps between last-good snapshots
    spike_window: int = 32
    spike_threshold: float = 10.0
    spike_min_history: int = 8
    skip_budget: int = 1         # ladder: rollbacks at this level only skip
    max_rollbacks: int = 3       # ladder: abort past this many per horizon
    clip_factor: float = 0.5     # grad-clip multiplier per tighten
    time_threshold: float = 10.0  # straggler bound (MAD multiples)


class SentryAbort(RuntimeError):
    """The escalation ladder ran out: repeated faults survived rollback,
    skip, and grad-clip tightening.  Carries the full event accounting."""

    def __init__(self, message: str, stats: dict):
        super().__init__(f"{message}; events={stats}")
        self.stats = dict(stats)


_STATE_ATTRS = ("params", "state", "opt_state", "sync_state")


def _snap(tree):
    """Owned host copies of a state tree's tensors (ints and None as they
    are)."""
    import torch

    from .checkpoint import _fetch
    if isinstance(tree, dict):
        return {k: _snap(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return _fetch(tree)
    return tree


def _restore(saved, live, device):
    """``saved`` put back into ``live``: each tensor copied into its live
    counterpart in place, a new tensor where none lives (on ``device``), a
    None where the snapshot had none, ints as saved."""
    import torch
    if isinstance(saved, dict):
        live = live if isinstance(live, dict) else {}
        return {k: _restore(v, live.get(k), device) for k, v in saved.items()}
    if not isinstance(saved, np.ndarray):
        return saved
    src = torch.from_numpy(saved)
    if isinstance(live, torch.Tensor) and live.shape == src.shape:
        with torch.no_grad():
            live.copy_(src)
        return live
    return src.clone().to(device)


class TrainingSentry:
    """Guard one trainer's step loop.  Usage::

        sentry = TrainingSentry(trainer)
        for batch in batches:
            loss = sentry.step(*batch)   # None = batch skipped (rollback)

    ``step`` runs ``trainer.train_step``, judges the result, and either
    returns the loss (clean) or rolls the trainer back and returns None:
    the caller's only job is to keep feeding batches.
    """

    def __init__(self, trainer, cfg: SentryConfig | None = None, *,
                 on_resize=None, log=print):
        self.trainer = trainer
        self.cfg = cfg or SentryConfig()
        # the resize rung: called ONCE a run, after rollback, skip and
        # clip tightening failed and before aborting; truthy means the
        # resize happened in-process and training goes on
        self.on_resize = on_resize
        self._resize_used = False

        # every sentry line also lands in the monitor's log ring, so a
        # postmortem bundle shows the escalation trail
        def _log(msg, _inner=log):
            monitor.log_line(str(msg))
            _inner(msg)
        self.log = _log
        self.detector = SpikeDetector(
            window=self.cfg.spike_window,
            threshold=self.cfg.spike_threshold,
            min_history=self.cfg.spike_min_history)
        self.time_detector = SpikeDetector(
            window=self.cfg.spike_window,
            threshold=self.cfg.time_threshold,
            min_history=self.cfg.spike_min_history,
            min_sigma=1e-4)
        self.stats = dict(steps=0, nonfinite=0, spikes=0, rollbacks=0,
                          skipped_steps=0, clip_tightened=0, stragglers=0,
                          snapshots=0, resizes=0)
        self._ladder = 0
        self._snap = None
        self._snap_step = 0
        self.snapshot()

    # -- last-good state ---------------------------------------------------
    def snapshot(self) -> None:
        """Host-copy the trainer's training state as last-good: OWNED
        copies (``checkpoint._fetch``), since the trainers update their
        tensors in place.  In a gang every rank snapshots its own state."""
        snap = {}
        for name in _STATE_ATTRS:
            tree = getattr(self.trainer, name, None)
            if tree is not None:
                snap[name] = _snap(tree)
        self._snap = snap
        self._snap_step = self.trainer._step
        self.stats["snapshots"] += 1
        self._ladder = 0  # a full clean horizon: recovery held

    def rollback(self) -> int:
        """Restore the last-good snapshot into the trainer's live state;
        returns the steps rewound."""
        device = getattr(self.trainer, "device", "cpu")
        rewound = self.trainer._step - self._snap_step
        for name, saved in self._snap.items():
            live = getattr(self.trainer, name)
            setattr(self.trainer, name, _restore(saved, live, device))
        self.trainer._step = self._snap_step
        self.stats["rollbacks"] += 1
        _tel_event("sentry_rollback", to_step=self._snap_step,
                   rewound=rewound)
        return rewound

    # -- escalation rungs --------------------------------------------------
    def request_resize(self, reason: str = "ladder") -> bool:
        """The resize rung as a public entry point: roll back to last-good
        once and hand the decision to the ``on_resize`` hook (what the
        exhausted ladder does; ``monitor.sentry_breach_hook`` wires an SLO
        breach here).  True iff the hook resized in-process and training
        continues with a fresh horizon; False when no hook is wired, the
        one resize was spent, or the hook declined."""
        if self.on_resize is None or self._resize_used:
            return False
        self._resize_used = True
        self.stats["resizes"] += 1
        rewound = self.rollback()
        self.stats["skipped_steps"] += rewound
        self.log(f"[sentry] requesting gang RESIZE ({reason}): rolled "
                 f"back {rewound} step(s) to last-good")
        _tel_event("sentry_resize", step=self.trainer._step,
                   rewound=rewound, reason=reason)
        if self.on_resize(dict(self.stats)):
            self._ladder = 0
            self.snapshot()
            return True
        return False

    # -- the guarded step --------------------------------------------------
    def _trainer_ok(self) -> bool:
        ok = getattr(self.trainer, "last_ok", None)
        # a flag averaged over replicas is fractional when one is poisoned:
        # healthy means exactly 1.0 everywhere
        if ok is None:
            return True
        if hasattr(ok, "detach"):
            ok = ok.detach().float().cpu().numpy()
        return bool(np.all(np.asarray(ok) >= 1.0))

    def step(self, *batch):
        """One guarded optimizer step; returns the loss, or None when the
        step was judged bad and the trainer was rolled back (the batch
        window since the last snapshot is skipped: continue with the NEXT
        batch)."""
        t0 = time.perf_counter()
        loss = self.trainer.train_step(*batch)
        loss_val = float(loss)
        elapsed = time.perf_counter() - t0

        trigger = None
        if not self._trainer_ok() or not np.isfinite(loss_val):
            trigger = "nonfinite"
        elif self.detector.update(loss_val):
            trigger = "spikes"

        if trigger is None:
            self.stats["steps"] += 1
            if self.time_detector.update(elapsed):
                # slow, not wrong: account, never roll back
                self.stats["stragglers"] += 1
            if (self.trainer._step - self._snap_step
                    >= self.cfg.checkpoint_every):
                self.snapshot()
            return loss_val

        self.stats[trigger] += 1
        self._ladder += 1
        self.log(f"[sentry] step {self.trainer._step - 1}: {trigger} "
                 f"(loss={loss_val:.6g}); escalation level {self._ladder}")
        _tel_event("sentry_trigger", kind=trigger,
                   step=self.trainer._step - 1, loss=loss_val,
                   ladder=self._ladder)
        if self._ladder > self.cfg.max_rollbacks:
            if self.request_resize(f"ladder:{trigger}"):
                return None
            _tel_event("sentry_abort", kind=trigger,
                       step=self.trainer._step - 1,
                       rollbacks=self.stats["rollbacks"])
            # flight recorder: the run's last moments before the abort
            monitor.write_postmortem(
                "sentry_abort",
                detail={"kind": trigger,
                        "step": int(self.trainer._step - 1),
                        "loss": loss_val,
                        "stats": {k: float(v)
                                  for k, v in self.stats.items()}},
                memory=monitor.memory_watermarks(
                    **{a: getattr(self.trainer, a, None)
                       for a in _STATE_ATTRS}))
            raise SentryAbort(
                f"{trigger} at step {self.trainer._step - 1} after "
                f"{self.stats['rollbacks']} rollbacks — escalation "
                f"ladder exhausted", self.stats)
        if self._ladder > self.cfg.skip_budget:
            tighten = getattr(self.trainer, "tighten_grad_clip", None)
            if tighten is not None:
                new_clip = tighten(self.cfg.clip_factor)
                self.stats["clip_tightened"] += 1
                self.log(f"[sentry] grad clip tightened to {new_clip:g}")
                _tel_event("sentry_clip_tightened", clip=float(new_clip))
        rewound = self.rollback()
        self.stats["skipped_steps"] += rewound
        self.log(f"[sentry] rolled back {rewound} step(s) to step "
                 f"{self._snap_step}; window skipped")
        return None
