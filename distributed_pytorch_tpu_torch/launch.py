"""Multi-process launcher: the port of the JAX package's launch.py, its
non-elastic gang.

The reference launches DDP with ``torchrun --nproc_per_node=1 --nnodes=4
--node_rank=R --master_addr=M --master_port=6585 main_ddp.py`` (reference
start_ddp.sh:1).  This agent speaks the same contract:

  python -m distributed_pytorch_tpu_torch.launch --nproc-per-node 4 -- \\
      -m distributed_pytorch_tpu_torch.cli --rendezvous env

Each worker gets MASTER_ADDR/MASTER_PORT/WORLD_SIZE/LOCAL_WORLD_SIZE/RANK/
LOCAL_RANK/NODE_RANK and RESTART_ATTEMPT; on the card a worker binds
``cuda:{LOCAL_RANK}`` (parallel/init.py), one process a GPU.  Failure
detection as in the JAX package: the agent polls its children, a worker
that exits non-zero tears the gang down (SIGTERM, then SIGKILL after a
grace period), and the gang restarts up to ``--max-restarts`` times or the
launcher exits with the failed worker's code; SIGTERM to the launcher
tears the gang down too.  Several nodes restart together through a
generation-numbered rendezvous that the node-0 agent hosts on
``--agent-port`` (default master_port + 1).

``--telemetry-dir D`` puts the gang on one timeline: the agent logs its
gang events (``worker_start``, ``worker_exit``, ``gang_done``) into D as
rank -1 ("agent" in the merged trace) and exports ``TELEMETRY_DIR=D`` to
the workers, whose CLIs stream into the same directory; a worker that
exits non-zero leaves a ``worker_fault`` postmortem bundle there
(utils/monitor.py; ``scripts/torch_postmortem.py D`` renders it).

A worker that exits ``FAULT_EXIT_CODE`` (an injected crash,
utils/faults.py) is restarted like any other and counted in
``GangResult.injected_failures``; a restarted worker resumes from its
checkpoint (``--checkpoint-dir`` of cli.py and lm_cli.py).

**Elastic resize** (``--elastic --min-nodes M --max-nodes N``): a worker
loss costs a reshard instead of the job.  The agent exports
``ELASTIC_DIR`` (the heartbeat directory), ``ELASTIC_MIN_NODES`` and
``ELASTIC_MAX_NODES``; each worker publishes ``hb_rank<R>.json`` there every
step (parallel/elastic.py ``Heartbeat``), so a hung worker whose PID is
alive goes stale and is killed (``--heartbeat-timeout``; a worker that has
not beaten in this generation is judged by its PID alone).  On a loss with
at least ``min_nodes`` survivors the agent drains them (SIGTERM: each
leaves the step loop at its next sync point, flushes a checkpoint and
exits ``ELASTIC_DRAIN_EXIT_CODE``, or is SIGKILLed after
``--drain-grace``) and starts the next generation one smaller, which
resumes from the checkpoint resharded (``load_resharded``).  A survivor
blocked in a collective with the dead peer cannot reach its sync point
(a signal handler runs only when the collective returns); it is the one
SIGKILLed at the grace, and the next generation resumes from the last
periodic checkpoint.  Once the lost slot is eligible again
(``--rejoin-delay``) and every running worker's beat advanced
``--grow-after-steps`` in the generation, the gang grows back the same
way.  A worker exiting ``ELASTIC_RESIZE_EXIT_CODE`` asks for a resize
itself.  ``--max-resizes`` bounds the shrinks; ``--max-restarts`` is not
read.  Every transition lands in ``GangResult.resize_events`` and, with
telemetry on, as ``gang_resize`` / ``heartbeat_stale`` / ``gang_drain``
events and an ``elastic_shrink`` postmortem.  One agent drives its own
workers (``--nnodes 1``, one worker a "node"); one process drives one
device, so on GPUs a gang of N needs N cards.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field

# The agent imports no torch: it supervises the workers that own the
# devices.  utils.telemetry, utils.monitor and utils.logging import none
# either, so its events and logs ride the workers' machinery.
from .utils import monitor, telemetry
from .utils.logging import get_logger, setup_logging

# Exit code of injected crashes (the JAX package's utils/faults.py).
FAULT_EXIT_CODE = 77

# Elastic-gang exit codes: how a worker left, never a failure.  DRAIN: it
# honoured the agent's drain (SIGTERM) at a step boundary, its checkpoint
# flushed.  RESIZE: it asks for a gang resize itself (the sentry's rung
# between rollback and abort); the agent treats it as a lost worker
# classified "requested".  parallel/elastic.py imports them from here.
ELASTIC_DRAIN_EXIT_CODE = 78
ELASTIC_RESIZE_EXIT_CODE = 79

# What the elastic agent exports to its workers besides the torchrun
# variables: the heartbeat directory and the resize bounds.
ELASTIC_DIR_ENV = "ELASTIC_DIR"
ELASTIC_MIN_ENV = "ELASTIC_MIN_NODES"
ELASTIC_MAX_ENV = "ELASTIC_MAX_NODES"
HEARTBEAT_PREFIX = "hb_rank"  # hb_rank<R>.json, written atomically

DEFAULT_PORT = 6585  # reference start_ddp.sh:1 / main_all_reduce.py:96
TERM_GRACE_S = 10.0
BARRIER_TIMEOUT_S = 600.0   # max skew between agents reaching a generation
RPC_TIMEOUT_S = 5.0         # status/fail round-trip budget
CONNECT_RETRY_S = 60.0      # waiting for the node-0 coordinator to come up


def _tel_event(name: str, **args) -> None:
    """A gang event (a worker's start or exit, a heartbeat gone stale, a
    drain, a resize, the gang's end) in the 'gang' lane when the agent
    runs with --telemetry-dir; free otherwise.  The agent's registry is
    rank -1 and generation 0; the generation an event belongs to rides in
    its args."""
    tel = telemetry.active()
    if tel is not None:
        tel.event(name, phase="gang", **args)


# -- heartbeats and liveness verdicts ------------------------------------------
# The beacons are the JAX package's: either package's reader reads the
# other's files.

def heartbeat_path(run_dir: str, rank: int) -> str:
    """Where member ``rank``'s beacon lands."""
    return os.path.join(run_dir, f"{HEARTBEAT_PREFIX}{rank}.json")


def read_heartbeat(path: str) -> dict | None:
    """One beacon: {rank, step, gen, time, age_s}; None for a missing,
    torn or mistyped file (beats are tmp + rename, so the next one lands
    whole).  ``age_s`` is judged from the file's mtime; ``time`` is
    optional."""
    try:
        with open(path) as f:
            hb = json.load(f)
        mtime = os.path.getmtime(path)
        return {"rank": int(hb["rank"]), "step": int(hb["step"]),
                "gen": int(hb["gen"]), "time": float(hb.get("time", mtime)),
                "age_s": time.time() - mtime}
    except (OSError, ValueError, KeyError, TypeError):
        return None


def pid_alive(pid: int | None) -> bool:
    """POSIX existence probe (signal 0): a permission error means the
    process exists; no pid reads as dead."""
    if not pid:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


def heartbeat_verdict(hb: dict | None, *, stale_s: float,
                      gen: int | None = None,
                      pid: int | None = None) -> str:
    """One member's state from its newest beat (``read_heartbeat``):
    ``"cold"`` (no beat, in generation ``gen`` when given: still starting,
    never a hang), ``"lost"`` (cold and the given ``pid`` is gone),
    ``"fresh"`` (the beat is younger than ``stale_s``) or ``"stale"``
    (beaten, then silent past ``stale_s``: a hung member with a live
    PID)."""
    if hb is None or (gen is not None and hb["gen"] != gen):
        return ("lost" if pid is not None and not pid_alive(pid)
                else "cold")
    return "stale" if hb["age_s"] > stale_s else "fresh"


class _Coordinator:
    """Generation rendezvous service hosted by the node-0 agent.

    One JSON message per TCP connection:
      {"op": "barrier", "node": R, "gen": G} -> blocks until every node
          arrives at generation G (or abort/done) -> {"ok", "abort",
          "world_size", "members"}
      {"op": "fail", "gen": G, "code": C}    -> records G as failed
      {"op": "status", "gen": G}             -> {"failed", "code", "abort"}
      {"op": "done", "node": R}              -> node R is settled: no
          further generations, running gangs are not torn down
      {"op": "abort"}                        -> no further generations, and
          running workers should be terminated
    """

    def __init__(self, nnodes: int, port: int):
        self.nnodes = nnodes
        self.members: set[int] = set(range(nnodes))
        self.cond = threading.Condition()
        self.arrived: dict[int, set[int]] = {}
        self.failed: dict[int, int] = {}
        self.abort = False
        self.done = False
        self.finished: set[int] = set()
        self.srv = socket.create_server(("0.0.0.0", port))
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:  # closed
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        with conn:
            try:
                conn.settimeout(BARRIER_TIMEOUT_S)
                msg = json.loads(conn.makefile("r").readline())
                op = msg["op"]
                with self.cond:
                    if op == "barrier":
                        gen = msg["gen"]
                        self.arrived.setdefault(gen, set()).add(msg["node"])
                        self.cond.notify_all()
                        ok = self.cond.wait_for(
                            lambda: (self.members
                                     <= self.arrived.get(gen, set())
                                     or self.abort or self.done),
                            timeout=BARRIER_TIMEOUT_S)
                        reply = {"ok": (bool(ok) and not self.abort
                                        and not self.done),
                                 "abort": self.abort,
                                 "world_size": len(self.members),
                                 "members": sorted(self.members)}
                    elif op == "fail":
                        self.failed.setdefault(msg["gen"],
                                               int(msg.get("code", 1)))
                        self.cond.notify_all()
                        reply = {"ok": True}
                    elif op == "done":
                        self.done = True
                        self.finished.add(int(msg.get("node", -1)))
                        self.cond.notify_all()
                        reply = {"ok": True}
                    elif op == "abort":
                        self.abort = True
                        self.cond.notify_all()
                        reply = {"ok": True}
                    else:  # status
                        gen = msg["gen"]
                        reply = {"failed": gen in self.failed,
                                 "code": self.failed.get(gen, 0),
                                 "abort": self.abort}
                conn.sendall((json.dumps(reply) + "\n").encode())
            except (OSError, ValueError, KeyError):
                pass

    def wait_all_finished(self, timeout: float) -> bool:
        """Block until every node has reported done; False on timeout."""
        with self.cond:
            return self.cond.wait_for(
                lambda: self.members <= self.finished, timeout=timeout)

    def close(self) -> None:
        try:
            self.srv.close()
        except OSError:
            pass


def _rpc(addr: str, port: int, msg: dict, timeout: float) -> dict:
    with socket.create_connection((addr, port), timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall((json.dumps(msg) + "\n").encode())
        return json.loads(s.makefile("r").readline())


@dataclass
class WorkerSpec:
    """One worker process's identity within the gang (the env contract of
    reference main_ddp.py:93-100)."""

    rank: int
    local_rank: int
    node_rank: int
    world_size: int
    local_world_size: int
    master_addr: str
    master_port: int

    def env(self) -> dict[str, str]:
        env = dict(os.environ)
        env.update(
            MASTER_ADDR=self.master_addr,
            MASTER_PORT=str(self.master_port),
            WORLD_SIZE=str(self.world_size),
            LOCAL_WORLD_SIZE=str(self.local_world_size),
            RANK=str(self.rank),
            LOCAL_RANK=str(self.local_rank),
            NODE_RANK=str(self.node_rank),
        )
        return env


@dataclass
class ElasticConfig:
    """The elastic policy of one agent: the gang's bounds (one worker a
    "node"), the hung-worker bound on a current-generation heartbeat's
    age, the drain grace before SIGKILL, the delay before a lost slot may
    rejoin, the steps every running worker must advance in a generation
    before the gang grows back, and the shrinks the run may absorb
    (grow-backs are free) before a loss fails it.  ``run_dir`` is the
    heartbeat directory (default: a new temporary one)."""

    min_workers: int = 1
    max_workers: int = 1
    heartbeat_timeout_s: float = 300.0
    drain_grace_s: float = 30.0
    rejoin_delay_s: float = 0.0
    grow_after_steps: int = 1
    max_resizes: int = 16
    run_dir: str | None = None

    def __post_init__(self):
        if not 1 <= self.min_workers <= self.max_workers:
            raise ValueError(
                f"elastic bounds must satisfy 1 <= min <= max, got "
                f"[{self.min_workers}, {self.max_workers}]")
        if self.max_resizes < 1:
            raise ValueError(
                f"max_resizes must be >= 1, got {self.max_resizes}")


@dataclass
class GangResult:
    """Outcome of a gang run: the final exit code, the rank that failed,
    the restarts used (the generations, under ``--elastic``), every rank's
    exit code, how many worker deaths were injected faults (exit
    ``FAULT_EXIT_CODE``; they use the same restart budget), every resize
    as ``{"gen", "kind" ("shrink"/"grow"), "from_size", "to_size",
    "reason", "rank"}``, and the teardown counts over the run ("drained":
    ``ELASTIC_DRAIN_EXIT_CODE`` exits, "exited": other exits under
    SIGTERM, "killed": needed SIGKILL)."""

    returncode: int
    failed_rank: int | None = None
    restarts_used: int = 0
    per_rank: dict[int, int] = field(default_factory=dict)
    injected_failures: int = 0
    resize_events: list = field(default_factory=list)
    drain: dict = field(default_factory=dict)

    @property
    def injected(self) -> bool:
        """The final failure (if any) was an injected fault."""
        return self.returncode == FAULT_EXIT_CODE


class LocalAgent:
    """Spawns and supervises this node's workers (torchrun's agent).

    ``argv`` is passed to the Python interpreter verbatim, so both script
    paths and modules (``-m pkg.cli ...``) work; ``worker_env`` is added to
    every worker's environment.  Every line the agent logs also lands in
    the monitor's log ring, so a postmortem bundle carries it.  With an
    ``ElasticConfig`` the gang resizes instead of restarting (one agent:
    ``nnodes`` must be 1)."""

    def __init__(self, argv: list[str], *, nnodes: int = 1,
                 node_rank: int = 0, nproc_per_node: int = 1,
                 master_addr: str = "127.0.0.1",
                 master_port: int = DEFAULT_PORT, max_restarts: int = 0,
                 monitor_interval_s: float = 0.1,
                 agent_port: int | None = None,
                 elastic: ElasticConfig | None = None, log=print,
                 worker_env: dict[str, str] | None = None):
        self.argv = argv
        self.nnodes = nnodes
        self.node_rank = node_rank
        self.nproc = nproc_per_node
        self.master_addr = master_addr
        self.master_port = master_port
        self.max_restarts = max_restarts
        self.monitor_interval_s = monitor_interval_s
        self.agent_port = (agent_port if agent_port is not None
                           else master_port + 1)
        self.worker_env = dict(worker_env or {})
        self.elastic = elastic
        if elastic is not None and nnodes > 1:
            raise ValueError(
                "elastic resize drives one agent's workers (nnodes=1, the "
                "worker-per-'node' CPU-simulation topology); coordinated "
                "multi-agent membership is the carried-forward half "
                "(ROADMAP 'Elastic gang + async relaxations')")

        def _log(msg, _inner=log):
            monitor.log_line(str(msg))
            _inner(msg)
        self.log = _log
        self._procs: dict[int, subprocess.Popen] = {}
        self._gen = 0  # current rendezvous generation (RESTART_ATTEMPT)
        self._drain_stats = {"drained": 0, "exited": 0, "killed": 0}

    def specs(self) -> list[WorkerSpec]:
        return self._specs_for(self.nproc)

    def _specs_for(self, nproc: int) -> list[WorkerSpec]:
        world = self.nnodes * nproc
        return [WorkerSpec(rank=self.node_rank * nproc + lr,
                           local_rank=lr, node_rank=self.node_rank,
                           world_size=world, local_world_size=nproc,
                           master_addr=self.master_addr,
                           master_port=self.master_port)
                for lr in range(nproc)]

    # -- process management ------------------------------------------------
    def _spawn(self, nproc: int | None = None,
               extra_env: dict[str, str] | None = None) -> None:
        for spec in self._specs_for(nproc if nproc is not None
                                    else self.nproc):
            env = spec.env()
            env["RESTART_ATTEMPT"] = str(self._gen)
            env.update(self.worker_env)
            env.update(extra_env or {})
            self._procs[spec.rank] = subprocess.Popen(
                [sys.executable] + self.argv, env=env)
            self.log(f"[launch] node {self.node_rank}: started rank "
                     f"{spec.rank} (pid {self._procs[spec.rank].pid})")
            _tel_event("worker_start", rank=spec.rank, gen=self._gen,
                       pid=self._procs[spec.rank].pid,
                       world_size=spec.world_size)

    def _terminate_all(self, grace_s: float = TERM_GRACE_S) -> dict:
        """SIGTERM the gang (a worker may reach a sync point, flush its
        checkpoint and exit ``ELASTIC_DRAIN_EXIT_CODE``), SIGKILL whoever
        is left after ``grace_s``; returns {"drained": drain-code exits,
        "exited": other exits under SIGTERM, "killed": needed SIGKILL},
        added to the run's ``GangResult.drain``."""
        outcome = {"drained": 0, "exited": 0, "killed": 0}
        live = [p for p in self._procs.values() if p.poll() is None]
        for p in live:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + grace_s
        for p in live:
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
                p.wait()
                outcome["killed"] += 1
            elif p.returncode == ELASTIC_DRAIN_EXIT_CODE:
                outcome["drained"] += 1
            else:
                outcome["exited"] += 1
        for k, v in outcome.items():
            self._drain_stats[k] += v
        if live:
            _tel_event("gang_drain", gen=self._gen, **outcome)
        return outcome

    def _gang_view(self, size: int | None = None) -> dict:
        """The agent's view of the gang for a postmortem bundle (``size``:
        the elastic gang's current size)."""
        return {
            "nnodes": self.nnodes, "node_rank": self.node_rank,
            "world_size": self.nnodes * (size if size is not None
                                         else self.nproc),
            "gen": self._gen,
            "ranks": {r: p.poll() for r, p in self._procs.items()},
        }

    def _postmortem(self, trigger: str, size: int | None = None,
                    **detail) -> str | None:
        """The flight recorder at a worker's failure: a bundle in the run's
        telemetry directory (the agent's registry, or the TELEMETRY_DIR
        its workers write to); without one there is nowhere to put it."""
        tel, env = telemetry.active(), telemetry.TELEMETRY_DIR_ENV
        run_dir = (tel.run_dir if tel is not None
                   else self.worker_env.get(env) or os.environ.get(env))
        if not run_dir:
            return None
        return monitor.write_postmortem(trigger, run_dir=run_dir, tel=tel,
                                        detail=detail,
                                        gang=self._gang_view(size))

    def _monitor(self, watch_remote: bool = False) -> GangResult:
        """Block until the gang finishes or any worker fails: a non-zero
        or signal-killed worker is noticed within ``monitor_interval_s``
        and the others are torn down instead of hanging in a collective.
        With ``watch_remote`` the coordinator is polled too, so a death on
        another node tears this node's workers down as promptly."""
        last_remote_check = 0.0
        while True:
            running = False
            for rank, p in self._procs.items():
                code = p.poll()
                if code is None:
                    running = True
                elif code != 0:
                    kind = ("injected fault" if code == FAULT_EXIT_CODE
                            else "failure")
                    self.log(f"[launch] rank {rank} FAILED with exit code "
                             f"{code} ({kind}); terminating gang")
                    _tel_event("worker_exit", rank=rank, gen=self._gen,
                               code=code, kind=kind)
                    self._postmortem("worker_fault", rank=rank, code=code,
                                     classified=kind)
                    self._terminate_all()
                    return GangResult(
                        returncode=code, failed_rank=rank,
                        per_rank={r: q.returncode
                                  for r, q in self._procs.items()},
                        injected_failures=int(code == FAULT_EXIT_CODE))
            if not running:
                return GangResult(returncode=0, per_rank={
                    r: p.returncode for r, p in self._procs.items()})
            now = time.monotonic()
            if watch_remote and now - last_remote_check >= max(
                    self.monitor_interval_s, 0.2):
                last_remote_check = now
                rep = None
                for attempt in (0, 1):  # one retry: a single RST/timeout
                    try:                # must not use a restart
                        rep = self._rpc_coord(
                            {"op": "status", "gen": self._gen},
                            RPC_TIMEOUT_S)
                        break
                    except (OSError, ValueError):
                        if attempt == 0:
                            time.sleep(0.5)
                if rep is None:
                    rep = {"failed": False, "abort": True, "code": 1}
                    self.log("[launch] coordinator unreachable; "
                             "terminating gang")
                if rep.get("failed") or rep.get("abort"):
                    self.log(f"[launch] remote failure in generation "
                             f"{self._gen}; terminating local workers")
                    self._terminate_all()
                    return GangResult(
                        returncode=rep.get("code") or 1,
                        per_rank={r: q.returncode
                                  for r, q in self._procs.items()})
            time.sleep(self.monitor_interval_s)

    # -- elastic resize -----------------------------------------------------
    def _heartbeats(self, run_dir: str) -> dict[int, dict]:
        """Every rank's newest readable beat in ``run_dir``: {rank:
        ``read_heartbeat``'s dict}; a torn or missing file is skipped (the
        next beat lands whole)."""
        out: dict[int, dict] = {}
        try:
            names = os.listdir(run_dir)
        except OSError:
            return out
        for name in names:
            if not (name.startswith(HEARTBEAT_PREFIX)
                    and name.endswith(".json")):
                continue
            hb = read_heartbeat(os.path.join(run_dir, name))
            if hb is not None:
                out[hb["rank"]] = hb
        return out

    def _clear_heartbeats(self, run_dir: str) -> None:
        try:
            for name in os.listdir(run_dir):
                if name.startswith(HEARTBEAT_PREFIX):
                    try:
                        os.remove(os.path.join(run_dir, name))
                    except OSError:
                        pass
        except OSError:
            pass

    def _run_elastic(self) -> GangResult:
        """Elastic supervision: a worker lost (its PID dead, its heartbeat
        stale, or its own request) within [min, max] costs a generation:
        drain the survivors, start the gang one smaller, which resumes
        from the resharded checkpoint; the gang grows back once the lost
        slot is eligible again and the smaller gang has advanced.  A
        heartbeat directory the agent made itself goes when it returns."""
        own = not self.elastic.run_dir
        run_dir = self.elastic.run_dir or tempfile.mkdtemp(
            prefix="elastic_gang_")
        os.makedirs(run_dir, exist_ok=True)
        try:
            return self._elastic_generations(run_dir)
        finally:
            if own:
                shutil.rmtree(run_dir, ignore_errors=True)

    def _elastic_generations(self, run_dir: str) -> GangResult:
        cfg = self.elastic
        size = cfg.max_workers
        lost_at: list[float] = []   # when each currently lost slot died
        injected = 0
        events: list[dict] = []

        def finish(code: int, failed_rank=None, per_rank=None) -> GangResult:
            return GangResult(
                returncode=code, failed_rank=failed_rank,
                restarts_used=self._gen,
                per_rank=per_rank if per_rank is not None else
                {r: p.returncode for r, p in self._procs.items()},
                injected_failures=injected, resize_events=events)

        while True:
            self._clear_heartbeats(run_dir)
            self._procs = {}
            self._spawn(size, extra_env={
                ELASTIC_DIR_ENV: run_dir,
                ELASTIC_MIN_ENV: str(cfg.min_workers),
                ELASTIC_MAX_ENV: str(cfg.max_workers),
            })
            try:
                kind, info = self._monitor_elastic(run_dir, size, lost_at)
            except BaseException:
                # Ctrl-C or SIGTERM to the agent: the workers still get the
                # configured drain window to flush their checkpoint
                self._terminate_all(grace_s=cfg.drain_grace_s)
                raise
            if kind == "done":
                return finish(0, per_rank=info)
            if kind == "grow":
                n_back = info
                self.log(f"[launch] elastic: {n_back} lost slot(s) "
                         f"rejoining; draining gang of {size} to grow to "
                         f"{size + n_back}")
                self._terminate_all(grace_s=cfg.drain_grace_s)
                events.append({"gen": self._gen, "kind": "grow",
                               "from_size": size, "to_size": size + n_back,
                               "reason": "rejoin", "rank": None})
                _tel_event("gang_resize", **events[-1])
                size += n_back
                del lost_at[:n_back]
                self._gen += 1
                continue
            # "lost": shrink by exactly the one lost slot.  A survivor may
            # be in a collective with the dead peer and leave messily in
            # the drain (a broken collective is a symptom, not a second
            # loss): every slot respawns at the new world size anyway
            rank, code, reason = info
            injected += int(code == FAULT_EXIT_CODE)
            new_size = size - 1
            shrinks = sum(1 for e in events if e["kind"] == "shrink")
            if shrinks >= cfg.max_resizes:
                self.log(f"[launch] elastic: rank {rank} lost ({reason}) "
                         f"after {shrinks} shrinks — resize budget "
                         f"max_resizes={cfg.max_resizes} exhausted; "
                         f"terminating gang")
                self._terminate_all(grace_s=cfg.drain_grace_s)
                return finish(code or 1, failed_rank=rank)
            if new_size < cfg.min_workers:
                self.log(f"[launch] elastic: rank {rank} lost ({reason}) "
                         f"leaves {new_size} < min_nodes="
                         f"{cfg.min_workers}; terminating gang")
                self._terminate_all(grace_s=cfg.drain_grace_s)
                return finish(code or 1, failed_rank=rank)
            self.log(f"[launch] elastic: rank {rank} lost ({reason}); "
                     f"draining survivors and resharding to world size "
                     f"{new_size}")
            self._terminate_all(grace_s=cfg.drain_grace_s)
            events.append({"gen": self._gen, "kind": "shrink",
                           "from_size": size, "to_size": new_size,
                           "reason": reason, "rank": rank})
            _tel_event("gang_resize", **events[-1])
            self._postmortem("elastic_shrink", size=new_size,
                             **{k: v for k, v in events[-1].items()
                                if k != "kind"})
            lost_at.append(time.monotonic())
            size = new_size
            self._gen += 1

    def _monitor_elastic(self, run_dir: str, size: int,
                         lost_at: list[float]):
        """Supervise one elastic generation; returns ("done", per_rank),
        ("lost", (rank, code, reason)) or ("grow", slots rejoining)."""
        cfg = self.elastic
        gen_start_step: dict[int, int] = {}   # rank -> first beat's step
        last_step: dict[int, int] = {}
        while True:
            per_rank: dict[int, int] = {}
            running = []
            for rank, p in self._procs.items():
                code = p.poll()
                per_rank[rank] = code
                if code is None:
                    running.append(rank)
                elif code == ELASTIC_RESIZE_EXIT_CODE:
                    self.log(f"[launch] rank {rank} requested a gang "
                             f"resize (exit {code})")
                    _tel_event("worker_exit", rank=rank, gen=self._gen,
                               code=code, kind="requested resize")
                    return "lost", (rank, 0, "requested")
                elif code != 0:
                    kind = ("injected fault" if code == FAULT_EXIT_CODE
                            else "failure")
                    self.log(f"[launch] rank {rank} FAILED with exit code "
                             f"{code} ({kind})")
                    _tel_event("worker_exit", rank=rank, gen=self._gen,
                               code=code, kind=kind)
                    self._postmortem("worker_fault", size=size, rank=rank,
                                     code=code, classified=kind)
                    return "lost", (rank, code, kind)
            if not running:
                return "done", per_rank
            # staleness, judged only after a rank's first beat of this
            # generation ("cold" before it: still starting); its PID is
            # watched by the poll above
            beats = self._heartbeats(run_dir)
            for rank in running:
                hb = beats.get(rank)
                verdict = heartbeat_verdict(
                    hb, stale_s=cfg.heartbeat_timeout_s, gen=self._gen)
                if verdict == "cold":
                    continue
                gen_start_step.setdefault(rank, hb["step"])
                last_step[rank] = hb["step"]
                if verdict == "stale":
                    self.log(f"[launch] rank {rank} heartbeat stale "
                             f"({hb['age_s']:.1f}s > "
                             f"{cfg.heartbeat_timeout_s}s); killing hung "
                             f"worker")
                    _tel_event("heartbeat_stale", rank=rank,
                               gen=self._gen, age_s=hb["age_s"],
                               timeout_s=cfg.heartbeat_timeout_s)
                    self._postmortem("worker_fault", size=size, rank=rank,
                                     code=None,
                                     classified="heartbeat_stale",
                                     age_s=hb["age_s"])
                    try:
                        self._procs[rank].kill()
                    except OSError:
                        pass
                    self._procs[rank].wait()
                    return "lost", (rank, 1, "heartbeat")
            # grow back: the lost slots past the rejoin delay, once every
            # running rank beat this generation and advanced enough (a
            # rank that finished no longer gates; one still cold does)
            if size < cfg.max_workers and lost_at:
                now = time.monotonic()
                eligible = sum(1 for t in lost_at
                               if now - t >= cfg.rejoin_delay_s)
                eligible = min(eligible, cfg.max_workers - size)
                advanced = bool(running) and all(
                    r in last_step
                    and last_step[r] - gen_start_step[r]
                    >= cfg.grow_after_steps
                    for r in running)
                if eligible > 0 and advanced:
                    return "grow", eligible
            time.sleep(self.monitor_interval_s)

    # -- gang orchestration -------------------------------------------------
    def _rpc_coord(self, msg: dict, timeout: float) -> dict:
        return _rpc(self.master_addr, self.agent_port, msg, timeout)

    def _barrier(self, gen: int) -> bool:
        """Arrive at generation ``gen``; True when every node is in.  The
        node-0 coordinator may come up after us: retry the dial."""
        deadline = time.monotonic() + CONNECT_RETRY_S
        while True:
            try:
                rep = self._rpc_coord(
                    {"op": "barrier", "node": self.node_rank, "gen": gen},
                    BARRIER_TIMEOUT_S + RPC_TIMEOUT_S)
                return bool(rep.get("ok"))
            except (OSError, ValueError):
                if time.monotonic() > deadline:
                    return False
                time.sleep(0.2)

    def run(self) -> GangResult:
        """Run the gang, restarting it up to ``max_restarts`` times on
        failure (every node in the same generation when there are
        several); with an ``ElasticConfig``, resizing it instead."""
        if self.elastic is not None:
            result = self._run_elastic()
        elif self.nnodes == 1:
            result = self._run_local()
        else:
            result = self._run_coordinated()
        result.drain = dict(self._drain_stats)
        return result

    def _run_local(self) -> GangResult:
        attempt = 0
        injected = 0
        while True:
            self._gen = attempt
            self._procs = {}
            self._spawn()
            try:
                result = self._monitor()
            except BaseException:
                # Ctrl-C, SIGTERM (via the main() handler), or any agent
                # crash: never leave workers orphaned on the devices
                self._terminate_all()
                raise
            injected += result.injected_failures
            result.injected_failures = injected
            result.restarts_used = attempt
            if result.returncode == 0 or attempt >= self.max_restarts:
                return result
            attempt += 1
            self.log(f"[launch] restarting gang (attempt {attempt}/"
                     f"{self.max_restarts})")

    def _send(self, msg: dict) -> None:
        """Best-effort coordinator notification."""
        try:
            self._rpc_coord(msg, RPC_TIMEOUT_S)
        except (OSError, ValueError):
            pass

    def _run_coordinated(self) -> GangResult:
        coord = (_Coordinator(self.nnodes, self.agent_port)
                 if self.node_rank == 0 else None)
        try:
            gen = 0
            injected = 0
            last: GangResult | None = None
            while True:
                self._gen = gen
                if not self._barrier(gen):
                    self.log(f"[launch] rendezvous for generation {gen} "
                             f"denied (done/abort/timeout)")
                    return last or GangResult(returncode=1)
                self._procs = {}
                self._spawn()
                try:
                    result = self._monitor(watch_remote=True)
                except BaseException:
                    self._terminate_all()
                    raise
                injected += result.injected_failures
                result.injected_failures = injected
                result.restarts_used = gen
                if result.returncode == 0:
                    return result
                last = result
                self._send({"op": "fail", "gen": gen,
                            "code": result.returncode})
                if gen >= self.max_restarts:
                    self._send({"op": "abort"})
                    return result
                gen += 1
                self.log(f"[launch] restarting gang, generation {gen}/"
                         f"{self.max_restarts}")
        finally:
            # settle this node with the coordinator however we leave; node
            # 0 keeps the coordinator up until every node has settled
            self._send({"op": "done", "node": self.node_rank})
            if coord is not None:
                if not coord.wait_all_finished(BARRIER_TIMEOUT_S):
                    self.log("[launch] not all nodes settled before "
                             "coordinator shutdown")
                coord.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_pytorch_tpu_torch.launch",
        description="torchrun-style launcher (reference start_ddp.sh:1) "
                    "with failure detection; one worker a GPU")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node-rank", "--node_rank", type=int, default=0)
    p.add_argument("--nproc-per-node", "--nproc_per_node", type=int,
                   default=1,
                   help="worker processes on this node, one a GPU "
                        "(cuda:{LOCAL_RANK})")
    p.add_argument("--master-addr", "--master_addr", default="127.0.0.1")
    p.add_argument("--master-port", "--master_port", type=int,
                   default=DEFAULT_PORT)
    p.add_argument("--max-restarts", type=int, default=0,
                   help="restarts of the whole gang on a worker failure")
    p.add_argument("--monitor-interval", type=float, default=0.1,
                   help="seconds between worker liveness polls")
    p.add_argument("--agent-port", type=int, default=None,
                   help="coordinator port for multi-node restarts "
                        "(default master_port+1; node 0 hosts)")
    # elastic resize: detect a worker's loss, shrink the gang at a drain
    # boundary, resume resharded from the checkpoint; grow back when the
    # slot rejoins
    p.add_argument("--elastic", action="store_true",
                   help="resize instead of restart: a worker loss within "
                        "[--min-nodes, --max-nodes] drains the survivors "
                        "at a sync point and re-rendezvouses one smaller "
                        "(resuming from the resharded checkpoint); the "
                        "gang grows back when the slot rejoins")
    p.add_argument("--min-nodes", type=int, default=1,
                   help="elastic: smallest world size worth training at "
                        "(fewer survivors fails the gang)")
    p.add_argument("--max-nodes", type=int, default=None,
                   help="elastic: largest world size (default "
                        "--nproc-per-node); the gang starts here and "
                        "grows back to it")
    p.add_argument("--heartbeat-timeout", type=float, default=300.0,
                   help="elastic: a worker whose newest heartbeat is "
                        "older than this is hung: killed and treated as "
                        "lost (a worker that never beat is judged by its "
                        "PID only)")
    p.add_argument("--drain-grace", type=float, default=30.0,
                   help="elastic: seconds the workers get to reach a sync "
                        "point and flush their checkpoint on SIGTERM "
                        "before SIGKILL")
    p.add_argument("--rejoin-delay", type=float, default=0.0,
                   help="elastic: seconds after a loss before the slot "
                        "may respawn (grow-back)")
    p.add_argument("--grow-after-steps", type=int, default=1,
                   help="elastic: grow back only after every running "
                        "worker's heartbeat advanced this many steps in "
                        "the shrunk generation")
    p.add_argument("--max-resizes", type=int, default=16,
                   help="elastic: shrinks the run may absorb before the "
                        "gang fails (grow-backs are free); --max-restarts "
                        "is not read under --elastic")
    p.add_argument("--telemetry-dir", default=None,
                   help="log the gang's events (worker start/exit, "
                        "heartbeat staleness, drains, resizes) into "
                        "this run directory and export it to the workers "
                        "(TELEMETRY_DIR), so every rank's stream merges "
                        "into one Chrome trace "
                        "(scripts/torch_telemetry_summary.py)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="worker command: a script path or '-m module', "
                        "optionally preceded by '--'")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging()
    log = get_logger("launch")
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        build_parser().error("no worker command given")
    elastic = None
    if args.elastic:
        max_workers = (args.max_nodes if args.max_nodes is not None
                       else args.nproc_per_node)
        if (args.max_nodes is not None and args.nproc_per_node != 1
                and args.nproc_per_node != args.max_nodes):
            build_parser().error(
                f"--elastic: --nproc-per-node {args.nproc_per_node} "
                f"conflicts with --max-nodes {args.max_nodes} (the gang "
                f"starts at max-nodes workers; set one, not both)")
        try:
            elastic = ElasticConfig(
                min_workers=args.min_nodes, max_workers=max_workers,
                heartbeat_timeout_s=args.heartbeat_timeout,
                drain_grace_s=args.drain_grace,
                rejoin_delay_s=args.rejoin_delay,
                grow_after_steps=args.grow_after_steps,
                max_resizes=args.max_resizes)
        except ValueError as e:
            build_parser().error(str(e))
        args.nproc_per_node = max_workers
    elif args.max_nodes is not None or args.min_nodes != 1:
        build_parser().error(
            "--min-nodes/--max-nodes configure elastic resize; pass "
            "--elastic (or drop the bounds)")
    # the workers stream into the agent's run directory
    worker_env = ({telemetry.TELEMETRY_DIR_ENV: args.telemetry_dir}
                  if args.telemetry_dir else {})
    try:
        agent = LocalAgent(
            cmd, nnodes=args.nnodes, node_rank=args.node_rank,
            nproc_per_node=args.nproc_per_node,
            master_addr=args.master_addr, master_port=args.master_port,
            max_restarts=args.max_restarts,
            monitor_interval_s=args.monitor_interval,
            agent_port=args.agent_port, elastic=elastic,
            worker_env=worker_env)
    except ValueError as e:  # --elastic with --nnodes > 1
        build_parser().error(str(e))
    if args.telemetry_dir:
        # the agent's own events: rank -1, "agent" in the merged trace
        telemetry.enable(args.telemetry_dir, rank=-1, gen=0, label="agent")
    try:
        # a scheduler's SIGTERM must tear down the gang, not orphan it:
        # raising SystemExit routes through run()'s BaseException cleanup
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
        result = agent.run()
        for ev in result.resize_events:
            log.info("resize: gen %d %s %d -> %d (%s)", ev["gen"],
                     ev["kind"], ev["from_size"], ev["to_size"],
                     ev["reason"])
        if result.drain:
            log.info("drain outcome: %s", result.drain)
        if result.returncode != 0:
            log.error("gang failed: rank %s exit %d after %d restarts",
                      result.failed_rank, result.returncode,
                      result.restarts_used)
        elif result.restarts_used:
            log.info("gang done after %d restart(s), %d of them after an "
                     "injected fault", result.restarts_used,
                     result.injected_failures)
        _tel_event("gang_done", returncode=result.returncode,
                   restarts_used=result.restarts_used,
                   resizes=len(result.resize_events), drain=result.drain)
    finally:
        if args.telemetry_dir:
            telemetry.disable()  # flush before the agent exits
    return result.returncode


if __name__ == "__main__":
    sys.exit(main())
