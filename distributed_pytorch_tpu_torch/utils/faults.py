"""Deterministic fault injection: the port of the JAX package's
utils/faults.py, its plans, gates and hooks.

A ``FaultPlan`` names one fault class, the step or generation it fires at
and a seed; every layer (the train step, the trainers' host loops, the
checkpoint writer, the rendezvous dial, the launcher) consults it through
hooks that do nothing when no plan is installed.  The classes
(``FaultPlan.kind``) are the JAX package's:

- ``nan_grad`` / ``inf_grad``: poison ONE gradient leaf, the leaf
  ``seed % n_leaves`` of the JAX package's tree order, at ``step``, after
  the backward and before the gradient sync, so the collective spreads it
  as it would a real bad shard;
- ``loss_spike``: multiply the loss by ``magnitude`` at ``step``;
- ``crash``: hard-exit the process (``FAULT_EXIT_CODE``) once ``step`` has
  run; the launcher classifies the exit as injected;
- ``ckpt_corrupt``: flip bytes in, or truncate, the next checkpoint file
  written (``corrupt_file`` directly for tests);
- ``rendezvous``: refuse the first ``count`` rendezvous dials
  (parallel/init.py retries with backoff and jitter);
- ``straggler``: sleep ``delay_s`` before each step in [``step``, ``step +
  count``);
- ``replica_loss`` and ``rpc_drop`` / ``rpc_torn`` / ``rpc_slow``: the
  serving fleet's faults, ``rank`` being the REPLICA id there
  (``maybe_kill_replica``, ``maybe_rpc_fault``; the fleet itself is slice
  5e's).

Plans are installed programmatically (``install``) or arrive as JSON in the
``FAULT_PLAN`` environment variable, which crosses the launcher's process
boundary.  ``gen`` gates a plan to one restart generation (the launcher's
``RESTART_ATTEMPT``): a crash plan fires in generation 0 and stays quiet
after the restart.  ``rank`` (-1: every process) scopes a process-level
fault to one gang member.

The JAX taps (``tap_grads`` / ``tap_loss``) are traced into the compiled
step and decide in it whether the armed step has come.  The port's step is
eager, so the host decides: given the step number and the host's arming
(``arm_window``), a tap launches the poison on the armed step alone and is
the identity, launching nothing, on every other step and with no plan.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass

import numpy as np

# Exit code workers use for injected crashes; launch.py classifies it.
FAULT_EXIT_CODE = 77

ENV_VAR = "FAULT_PLAN"

RPC_KINDS = ("rpc_drop", "rpc_torn", "rpc_slow")
KINDS = ("nan_grad", "inf_grad", "loss_spike", "crash", "ckpt_corrupt",
         "rendezvous", "straggler", "replica_loss") + RPC_KINDS


@dataclass
class FaultPlan:
    """One scheduled fault.  ``step`` is the trainer's global step counter
    for step-scoped kinds; ``gen`` the restart generation the plan is live
    in (-1 = every generation); ``rank`` the process it fires on (-1 =
    all)."""

    kind: str
    step: int = 0
    seed: int = 0
    gen: int = 0
    rank: int = -1
    magnitude: float = 1e4   # loss_spike multiplier
    delay_s: float = 0.0     # straggler sleep per step
    # rendezvous refusals / straggler steps / grad-loss firings: 1 is a
    # transient fault (it fires once even if a sentry rollback re-crosses
    # the step), more a persistent one (the escalation ladder)
    count: int = 1
    # ckpt_corrupt: 'bitflip' | 'truncate'; rpc_torn: 'header' | 'payload'
    # | 'crc'
    mode: str = "bitflip"
    # rpc_* only: scope the plan to one RPC op ("" = any call)
    op: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")

    def to_env(self) -> str:
        return json.dumps(asdict(self))


_PLAN: FaultPlan | None = None
_PLAN_FROM_ENV = False


def install(plan: FaultPlan | None) -> None:
    """Install (or clear, with None) the process-wide fault plan.
    Programmatic installs shadow the environment variable."""
    global _PLAN, _PLAN_FROM_ENV
    _PLAN = plan
    _PLAN_FROM_ENV = False


def get_plan() -> FaultPlan | None:
    """The active plan: a programmatic install, else ``FAULT_PLAN`` from
    the environment (parsed once), else None."""
    global _PLAN, _PLAN_FROM_ENV
    if _PLAN is not None:
        return _PLAN
    if not _PLAN_FROM_ENV:
        raw = os.environ.get(ENV_VAR)
        if raw:
            _PLAN = FaultPlan(**json.loads(raw))
        _PLAN_FROM_ENV = True
    return _PLAN


def _gen_live(plan: FaultPlan) -> bool:
    if plan.gen < 0:
        return True
    return int(os.environ.get("RESTART_ATTEMPT", "0")) == plan.gen


def _rank_live(plan: FaultPlan) -> bool:
    """The plan's rank against this process's: the default process
    group's rank when one is up, else the launcher's ``RANK`` (0 outside
    any gang)."""
    if plan.rank < 0:
        return True
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == plan.rank
    return int(os.environ.get("RANK", "0")) == plan.rank


def armed(kind: str) -> FaultPlan | None:
    """The plan, iff it matches ``kind`` and this generation/process."""
    plan = get_plan()
    if (plan is not None and plan.kind == kind and _gen_live(plan)
            and _rank_live(plan)):
        return plan
    return None


# -- the step taps ------------------------------------------------------------

_STEP_FAULTS_FIRED = 0


def step_plan() -> FaultPlan | None:
    """The armed plan, if it is one of the step-keyed tap kinds."""
    return armed("nan_grad") or armed("inf_grad") or armed("loss_spike")


def arm_window(step0: int, k: int = 1) -> float:
    """Host-side one-shot arming for the taps: 1.0 iff a grad/loss plan's
    step falls inside the dispatch window [step0, step0 + k) with firings
    left (``plan.count``), marking one firing consumed.  The gate gives
    step-keyed faults ONCE semantics across a sentry rollback, which
    rewinds the step counter across the fault step."""
    global _STEP_FAULTS_FIRED
    plan = step_plan()
    if plan is None or _STEP_FAULTS_FIRED >= plan.count:
        return 0.0
    if step0 <= plan.step < step0 + k:
        _STEP_FAULTS_FIRED += 1
        return 1.0
    return 0.0


def _hit(plan: FaultPlan | None, step, fault_arm) -> bool:
    return (plan is not None and int(step) == plan.step
            and float(fault_arm) > 0.0)


def tap_index(plan: FaultPlan, n_leaves: int) -> int:
    """The leaf a grad plan poisons: ``seed % n_leaves`` of the leaves in
    the JAX package's tree order (``jax.tree.flatten``: dict keys sorted at
    every level)."""
    return plan.seed % n_leaves


def tap_grads(grads, step, fault_arm=0.0):
    """Poison one gradient leaf with NaN/Inf when ``step`` is the plan's
    and the host armed this dispatch (``fault_arm``, from ``arm_window``).
    ``grads`` is a list of tensors in the JAX package's tree order; the
    result is a new list whose tapped entry is ``leaf + bad`` in the
    leaf's dtype (a new tensor), the others the inputs.  No plan, or
    another step: ``grads`` itself, and nothing launched."""
    plan = grad_tap(step, fault_arm)
    if plan is None:
        return grads
    out = list(grads)
    i = tap_index(plan, len(out))
    out[i] = poison(plan, out[i])
    return out


def poison(plan: FaultPlan, leaf):
    """``leaf + bad`` in the leaf's dtype (bad: NaN or Inf): one
    elementwise operation."""
    bad = float("nan") if plan.kind == "nan_grad" else float("inf")
    return (leaf + bad).to(leaf.dtype)


def grad_tap(step, fault_arm=0.0) -> FaultPlan | None:
    """The grad plan iff it fires at this step: for a sync that taps leaf
    by leaf (the overlapped sync poisons leaf ``tap_index`` with
    ``poison`` before its bucket is launched)."""
    plan = armed("nan_grad") or armed("inf_grad")
    return plan if _hit(plan, step, fault_arm) else None


def tap_loss(loss, step, fault_arm=0.0):
    """The loss times ``magnitude`` at the plan's (host-armed) step;
    ``loss`` itself otherwise, and nothing launched."""
    plan = armed("loss_spike")
    if not _hit(plan, step, fault_arm):
        return loss
    return loss * plan.magnitude


# -- host hooks ---------------------------------------------------------------

def maybe_crash(step: int, window: int = 1, before_exit=None) -> None:
    """Hard-exit (no teardown, no final checkpoint) once the trainer's
    counter reaches/passes the plan's step.  ``step`` is the
    POST-dispatch counter and ``window`` the steps that dispatch ran, so
    the trigger is the (step - window, step] interval.  The distinctive
    exit code lets the launcher classify the death as injected.

    ``before_exit`` (the LM trainer passes its checkpoint flush) runs just
    before the exit: the checkpoint write already in flight lands, so the
    crash's resume point is the last save before the crash step rather
    than a race between the background write and the fault step."""
    plan = armed("crash")
    if plan is not None and step - window < plan.step <= step:
        if before_exit is not None:
            before_exit()
        print(f"[faults] injected crash at step {plan.step} "
              f"(dispatch boundary {step})", flush=True)
        os._exit(FAULT_EXIT_CODE)


def maybe_delay(step: int, window: int = 1) -> None:
    """Straggler: sleep ``delay_s`` before any dispatch whose window
    [step, step + window) intersects the plan's [step, step + count)."""
    plan = armed("straggler")
    if plan is not None and (plan.step < step + window
                             and step < plan.step + plan.count):
        time.sleep(plan.delay_s)


def maybe_kill_replica(replica: int, tick: int) -> bool:
    """``replica_loss``: True exactly ``count`` times once the fleet's poll
    tick reaches the plan's ``step``, for the planned replica (``rank`` is
    the REPLICA id, -1 any; the generation gate applies, the process-rank
    gate does not: the fleet runs in one process)."""
    plan = get_plan()
    if (plan is None or plan.kind != "replica_loss"
            or not _gen_live(plan)):
        return False
    if 0 <= plan.rank != replica:
        return False
    if tick < plan.step or plan.count <= 0:
        return False
    plan.count -= 1
    return True


def maybe_rpc_fault(replica: int, call: int,
                    op: str | None = None) -> FaultPlan | None:
    """``rpc_drop`` / ``rpc_torn`` / ``rpc_slow``: the plan, exactly
    ``count`` times once the server's call counter reaches the plan's
    ``step``, for the planned replica (``rank`` the REPLICA id, -1 any),
    and with ``op`` set only on calls of that op.  The caller acts on
    ``plan.kind`` / ``mode`` / ``delay_s``."""
    plan = get_plan()
    if (plan is None or plan.kind not in RPC_KINDS
            or not _gen_live(plan)):
        return None
    if 0 <= plan.rank != replica:
        return None
    if plan.op and plan.op != op:
        return None
    if call < plan.step or plan.count <= 0:
        return None
    plan.count -= 1
    return plan


_RDZV_FAILED = 0


def maybe_refuse_rendezvous() -> None:
    """ConnectionRefusedError for the first ``count`` dials: the flapping
    coordinator parallel/init.py retries through."""
    global _RDZV_FAILED
    plan = armed("rendezvous")
    if plan is not None and _RDZV_FAILED < plan.count:
        _RDZV_FAILED += 1
        raise ConnectionRefusedError(
            f"[faults] injected rendezvous refusal "
            f"{_RDZV_FAILED}/{plan.count}")


def reset() -> None:
    """Clear all fault state (tests)."""
    global _RDZV_FAILED, _STEP_FAULTS_FIRED
    _RDZV_FAILED = 0
    _STEP_FAULTS_FIRED = 0
    install(None)


# -- checkpoint corruption ----------------------------------------------------

def corrupt_file(path: str, mode: str = "bitflip", seed: int = 0,
                 nbytes: int = 8) -> None:
    """Corrupt ``path`` in place: flip ``nbytes`` pseudo-random bytes
    (``bitflip``, past the first 512 bytes, so the payload and not the
    archive's headers takes them) or cut the file to half its length
    (``truncate``); deterministic given ``seed``, the JAX package's bytes
    exactly."""
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
        return
    if mode != "bitflip":
        raise ValueError(f"unknown corruption mode {mode!r}")
    rng = np.random.default_rng(seed)
    lo = min(512, size - 1)
    offs = rng.integers(lo, size, nbytes)
    with open(path, "r+b") as f:
        for off in offs:
            f.seek(int(off))
            b = f.read(1)
            f.seek(int(off))
            f.write(bytes([b[0] ^ 0xFF]))


def maybe_corrupt_checkpoint(path: str) -> None:
    """Post-write hook: corrupt the just-published checkpoint file when a
    ``ckpt_corrupt`` plan is armed (fires ``count`` times)."""
    plan = armed("ckpt_corrupt")
    if plan is None or plan.count <= 0:
        return
    plan.count -= 1
    corrupt_file(path, mode=plan.mode, seed=plan.seed)
    print(f"[faults] corrupted checkpoint {path} ({plan.mode})",
          flush=True)
