"""Elastic gang, worker side: the port of the JAX package's
parallel/elastic.py (heartbeats, drain sync points, resize).

launch.py's elastic agent turns a worker loss into a reshard instead of a
dead job; this module is the half that runs inside the workers:

- ``Heartbeat``: each worker publishes ``hb_rank<R>.json`` into the agent's
  ``ELASTIC_DIR`` once a step (tmp + rename, so the agent never reads a
  torn file).  A hung worker (a stuck collective, a wedged host thread)
  goes stale and is detected although its PID is alive.
- ``DrainGuard``: the agent's SIGTERM becomes "leave the step loop at the
  next sync point".  The ranks see the signal skewed by up to a step, and
  a rank that drains (its checkpoint may gather) while a peer goes on into
  the next step's collectives deadlocks both, so ``sync()`` takes the
  maximum of every rank's flag each step and every rank leaves at the same
  boundary.  The flag is agreed over a Gloo group of the same ranks with a
  CPU tensor: an all-reduce of a CUDA flag read back each step would make
  the host wait for the device queue every step.  After the flush the
  worker exits ``ELASTIC_DRAIN_EXIT_CODE``.
- ``reshard_from_checkpoint``: ``trainer.rebuild`` then the trainer's
  restore, which reads a per-shard checkpoint through
  ``ShardedCheckpointer.load_resharded`` onto the layout it has now.  One
  process drives one device, so a rebuild keeps the world size: a gang of
  another size is the next generation of processes, which restores
  through the same loader.
"""

from __future__ import annotations

import json
import os
import signal
import time
from dataclasses import dataclass

# The agent side owns the constants (launch.py imports no torch); these
# are they, so the two halves cannot drift.
from ..launch import (  # noqa: F401  (re-exported for workers)
    ELASTIC_DIR_ENV,
    ELASTIC_DRAIN_EXIT_CODE,
    ELASTIC_MAX_ENV,
    ELASTIC_MIN_ENV,
    ELASTIC_RESIZE_EXIT_CODE,
    HEARTBEAT_PREFIX,
)


@dataclass
class ElasticContext:
    """The elastic environment contract as one object (``from_env`` is
    None when no elastic agent launched the worker)."""

    run_dir: str
    rank: int
    world_size: int
    generation: int
    min_nodes: int
    max_nodes: int

    @classmethod
    def from_env(cls) -> "ElasticContext | None":
        run_dir = os.environ.get(ELASTIC_DIR_ENV)
        if not run_dir:
            return None
        return cls(
            run_dir=run_dir,
            rank=int(os.environ.get("RANK", "0")),
            world_size=int(os.environ.get("WORLD_SIZE", "1")),
            generation=int(os.environ.get("RESTART_ATTEMPT", "0")),
            min_nodes=int(os.environ.get(ELASTIC_MIN_ENV, "1")),
            max_nodes=int(os.environ.get(ELASTIC_MAX_ENV, "1")),
        )


class Heartbeat:
    """Per-step liveness beacon: ``beat(step)`` publishes {rank, step,
    gen, time} to ``hb_rank<R>.json`` atomically.  ``min_interval_s``
    rate-limits the rewrites (0: every call); the first beat always lands
    (the agent judges staleness from a generation's first beat on, so
    silence before it reads as starting, never as hung)."""

    def __init__(self, run_dir: str, rank: int, generation: int,
                 *, min_interval_s: float = 0.0):
        self.run_dir = run_dir
        self.rank = rank
        self.generation = generation
        self.min_interval_s = min_interval_s
        self._last = 0.0
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir,
                                 f"{HEARTBEAT_PREFIX}{rank}.json")

    def beat(self, step: int) -> None:
        now = time.time()
        if self._last and now - self._last < self.min_interval_s:
            return
        self._last = now
        tmp = self.path + f".tmp{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"rank": self.rank, "step": int(step),
                           "gen": self.generation, "time": now}, f)
            os.replace(tmp, self.path)  # atomic: never seen torn
        except OSError:
            pass  # a missed beat is a late detection, not a crash


class DrainGuard:
    """SIGTERM -> a drain at the next sync point, agreed by every rank.

    ``install()`` replaces the SIGTERM disposition (install it early: a
    SIGTERM before the first sync point is honoured there).  ``sync()`` is
    the per-step sync point: the maximum of every rank's flag, so all
    ranks leave at the same boundary although the signal lands skewed."""

    def __init__(self):
        self._requested = False
        self._group = None  # the Gloo group of sync(), made on first use

    def install(self) -> "DrainGuard":
        signal.signal(signal.SIGTERM, self._handler)
        return self

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def requested(self) -> bool:
        """The local flag (no agreement), for a single-process run."""
        return self._requested

    def _gloo_group(self):
        """The group to agree over: a Gloo group of every rank, whatever
        the default group's backend, made once (a collective: every rank
        makes it at the same first sync point)."""
        import torch.distributed as dist
        if self._group is None:
            self._group = dist.new_group(backend="gloo")
        return self._group

    def sync(self) -> bool:
        """True when any rank has seen the drain signal: every rank gets
        the same answer at the same step boundary.  One one-element CPU
        all-reduce a step, which waits on no device work; with one rank
        (or no process group) the local flag."""
        import torch.distributed as dist
        if not dist.is_initialized() or dist.get_world_size() <= 1:
            return self._requested
        import torch
        flag = torch.tensor([1.0 if self._requested else 0.0])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._gloo_group())
        return bool(flag.item() > 0.0)


def drain_exit(save_fn, *, log=print, code: int = ELASTIC_DRAIN_EXIT_CODE):
    """Flush the state and leave at this sync point: runs ``save_fn`` (the
    caller's checkpoint-and-flush closure; it may be collective, since
    every rank calls ``drain_exit`` at the boundary ``DrainGuard.sync``
    agreed) and exits with the drain code.  ``os._exit`` on purpose: the
    teardown of a half-dismantled gang can hang, and the checkpoint is on
    disk."""
    try:
        save_fn()
    except Exception as e:  # noqa: BLE001 — the agent's grace covers us
        if log:
            log(f"[elastic] drain checkpoint failed ({e}); exiting anyway")
    if log:
        log(f"[elastic] drained at sync point (exit {code})", )
    os._exit(code)


def reshard_from_checkpoint(trainer, directory: str, **rebuild_kw) -> int:
    """Rebuild ``trainer`` (``rebuild_kw`` to ``trainer.rebuild``) and
    restore the latest checkpoint in ``directory`` onto its layout (the LM
    trainer's ``maybe_restore``, which reads a per-shard checkpoint
    through ``ShardedCheckpointer.load_resharded``; the VGG trainer's
    ``Checkpointer``).  Returns the step (or epoch) resumed from."""
    trainer.rebuild(**rebuild_kw)
    if hasattr(trainer, "maybe_restore"):
        return trainer.maybe_restore(directory)
    from ..utils.checkpoint import Checkpointer

    return Checkpointer(directory).maybe_restore(trainer)
