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
checkpoint (``--checkpoint-dir`` of cli.py and lm_cli.py).  Elastic resize
(``--elastic`` and its bounds) and heartbeats belong to slice 5c-iii and
raise ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field

# The agent imports no torch: it supervises the workers that own the
# devices.  utils.telemetry, utils.monitor and utils.logging import none
# either, so its events and logs ride the workers' machinery.
from .utils import monitor, telemetry
from .utils.logging import get_logger, setup_logging

ELASTIC_SLICE = "ROADMAP.md queue 1, slice 5c-iii (elastic)"

# Exit code of injected crashes (the JAX package's utils/faults.py).
FAULT_EXIT_CODE = 77

DEFAULT_PORT = 6585  # reference start_ddp.sh:1 / main_all_reduce.py:96
TERM_GRACE_S = 10.0
BARRIER_TIMEOUT_S = 600.0   # max skew between agents reaching a generation
RPC_TIMEOUT_S = 5.0         # status/fail round-trip budget
CONNECT_RETRY_S = 60.0      # waiting for the node-0 coordinator to come up


def _tel_event(name: str, **args) -> None:
    """A gang event (a worker's start or exit, the gang's end) in the
    'gang' lane when the agent runs with --telemetry-dir; free otherwise.
    The agent's registry is rank -1 and generation 0; the generation an
    event belongs to rides in its args."""
    tel = telemetry.active()
    if tel is not None:
        tel.event(name, phase="gang", **args)


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
class GangResult:
    """Outcome of a gang run: the final exit code, the rank that failed,
    the restarts used, every rank's exit code, how many worker deaths were
    injected faults (exit ``FAULT_EXIT_CODE``; they use the same restart
    budget), and the teardown counts ("exited" under SIGTERM, "killed")."""

    returncode: int
    failed_rank: int | None = None
    restarts_used: int = 0
    per_rank: dict[int, int] = field(default_factory=dict)
    injected_failures: int = 0
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
    the monitor's log ring, so a postmortem bundle carries it."""

    def __init__(self, argv: list[str], *, nnodes: int = 1,
                 node_rank: int = 0, nproc_per_node: int = 1,
                 master_addr: str = "127.0.0.1",
                 master_port: int = DEFAULT_PORT, max_restarts: int = 0,
                 monitor_interval_s: float = 0.1,
                 agent_port: int | None = None, log=print,
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

        def _log(msg, _inner=log):
            monitor.log_line(str(msg))
            _inner(msg)
        self.log = _log
        self._procs: dict[int, subprocess.Popen] = {}
        self._gen = 0  # current rendezvous generation (RESTART_ATTEMPT)
        self._drain_stats = {"exited": 0, "killed": 0}

    def specs(self) -> list[WorkerSpec]:
        world = self.nnodes * self.nproc
        return [WorkerSpec(rank=self.node_rank * self.nproc + lr,
                           local_rank=lr, node_rank=self.node_rank,
                           world_size=world, local_world_size=self.nproc,
                           master_addr=self.master_addr,
                           master_port=self.master_port)
                for lr in range(self.nproc)]

    # -- process management ------------------------------------------------
    def _spawn(self) -> None:
        for spec in self.specs():
            env = spec.env()
            env["RESTART_ATTEMPT"] = str(self._gen)
            env.update(self.worker_env)
            self._procs[spec.rank] = subprocess.Popen(
                [sys.executable] + self.argv, env=env)
            self.log(f"[launch] node {self.node_rank}: started rank "
                     f"{spec.rank} (pid {self._procs[spec.rank].pid})")
            _tel_event("worker_start", rank=spec.rank, gen=self._gen,
                       pid=self._procs[spec.rank].pid,
                       world_size=spec.world_size)

    def _terminate_all(self, grace_s: float = TERM_GRACE_S) -> dict:
        """SIGTERM the gang, SIGKILL whoever is left after ``grace_s``;
        returns {"exited": left under SIGTERM, "killed": needed SIGKILL}."""
        outcome = {"exited": 0, "killed": 0}
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
            else:
                outcome["exited"] += 1
        for k, v in outcome.items():
            self._drain_stats[k] += v
        return outcome

    def _gang_view(self) -> dict:
        """The agent's view of the gang for a postmortem bundle."""
        return {
            "nnodes": self.nnodes, "node_rank": self.node_rank,
            "world_size": self.nnodes * self.nproc, "gen": self._gen,
            "ranks": {r: p.poll() for r, p in self._procs.items()},
        }

    def _postmortem(self, trigger: str, **detail) -> str | None:
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
                                        gang=self._gang_view())

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
        several)."""
        result = (self._run_local() if self.nnodes == 1
                  else self._run_coordinated())
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
    # elastic resize: slice 5c-iii
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--min-nodes", type=int, default=1)
    p.add_argument("--max-nodes", type=int, default=None)
    p.add_argument("--heartbeat-timeout", type=float, default=300.0)
    p.add_argument("--drain-grace", type=float, default=30.0)
    p.add_argument("--rejoin-delay", type=float, default=0.0)
    p.add_argument("--grow-after-steps", type=int, default=1)
    p.add_argument("--max-resizes", type=int, default=16)
    p.add_argument("--telemetry-dir", default=None,
                   help="log the gang's events (worker start/exit) into "
                        "this run directory and export it to the workers "
                        "(TELEMETRY_DIR), so every rank's stream merges "
                        "into one Chrome trace "
                        "(scripts/torch_telemetry_summary.py)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="worker command: a script path or '-m module', "
                        "optionally preceded by '--'")
    return p


# (flag, the value that leaves it off): elastic resize
_LATER_FLAGS = [("--elastic", False), ("--min-nodes", 1),
                ("--max-nodes", None), ("--heartbeat-timeout", 300.0),
                ("--drain-grace", 30.0), ("--rejoin-delay", 0.0),
                ("--grow-after-steps", 1), ("--max-resizes", 16)]


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging()
    log = get_logger("launch")
    for flag, off in _LATER_FLAGS:
        value = getattr(args, flag[2:].replace("-", "_"))
        if value != off:
            raise NotImplementedError(
                f"launch {flag} {value!r} is not ported to PyTorch yet: "
                f"{ELASTIC_SLICE}")
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        build_parser().error("no worker command given")
    worker_env = {}
    if args.telemetry_dir:
        # the agent's own events (rank -1, "agent" in the merged trace),
        # and the workers' streams in the same run directory
        telemetry.enable(args.telemetry_dir, rank=-1, gen=0, label="agent")
        worker_env[telemetry.TELEMETRY_DIR_ENV] = args.telemetry_dir
    try:
        agent = LocalAgent(
            cmd, nnodes=args.nnodes, node_rank=args.node_rank,
            nproc_per_node=args.nproc_per_node,
            master_addr=args.master_addr, master_port=args.master_port,
            max_restarts=args.max_restarts,
            monitor_interval_s=args.monitor_interval,
            agent_port=args.agent_port, worker_env=worker_env)
        # a scheduler's SIGTERM must tear down the gang, not orphan it:
        # raising SystemExit routes through run()'s BaseException cleanup
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
        result = agent.run()
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
                   restarts_used=result.restarts_used, drain=result.drain)
    finally:
        if args.telemetry_dir:
            telemetry.disable()  # flush before the agent exits
    return result.returncode


if __name__ == "__main__":
    sys.exit(main())
