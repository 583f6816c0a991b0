"""Multi-process rendezvous: the port of the JAX package's parallel/init.py.

The reference rendezvouses its workers over TCP in one of two ways:

- explicit: ``init_process_group('gloo', init_method='tcp://<master-ip>:6585',
  world_size, rank)`` from ``--master-ip/--num-nodes/--rank`` (reference
  main_all_reduce.py:86-96) -> ``init_distributed``;
- env-var: torchrun sets MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK (reference
  main_ddp.py:93-104) -> ``init_from_env``.

Both keep the JAX package's contract: a real default timeout, retries of a
failed dial with capped exponential backoff and a seeded per-(rank,
attempt) jitter, the ``JAX_GRAFT_RDZV_ATTEMPTS`` /
``JAX_GRAFT_RDZV_BACKOFF_CAP_S`` overrides, and a ``RendezvousError``
naming the coordinator.  The process group is ``torch.distributed``'s: the
backend follows the device, NCCL for ``cuda`` and Gloo for ``cpu``, and a
failed NCCL initialisation raises rather than falling back to Gloo.  One
process drives one card: on ``cuda`` the process binds
``cuda:{local_rank}`` (``LOCAL_RANK`` from the launcher) before any CUDA
tensor exists and hands that device to the group, so that every rank does
not land on ``cuda:0``.

With ``num_nodes == 1`` nothing happens here, as in the JAX package; the
one-rank group the data-parallel strategies run over is made by
``mesh.make_mesh``.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DEFAULT_PORT = 6585  # the reference's hard-coded port (main_all_reduce.py:96)
DEFAULT_TIMEOUT_S = 300
CONNECT_ATTEMPTS = 5     # rendezvous dials before giving up
BACKOFF_BASE_S = 1.0     # first retry delay (doubles per attempt)
BACKOFF_CAP_S = 30.0     # ceiling on any single delay

# The JAX package's env overrides, under the same names.
ATTEMPTS_ENV = "JAX_GRAFT_RDZV_ATTEMPTS"
BACKOFF_CAP_ENV = "JAX_GRAFT_RDZV_BACKOFF_CAP_S"


def _env_positive(name: str, default, cast):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        val = cast(raw)
    except ValueError:
        val = None
    if val is None or val <= 0:
        raise ValueError(
            f"{name} must be a positive {cast.__name__}, got {raw!r}")
    return val


def rdzv_attempts_from_env(default: int = CONNECT_ATTEMPTS) -> int:
    """The retry budget: JAX_GRAFT_RDZV_ATTEMPTS, else ``default``."""
    return _env_positive(ATTEMPTS_ENV, default, int)


def rdzv_backoff_cap_from_env(default: float = BACKOFF_CAP_S) -> float:
    """The per-delay ceiling: JAX_GRAFT_RDZV_BACKOFF_CAP_S, else
    ``default``."""
    return _env_positive(BACKOFF_CAP_ENV, default, float)


class RendezvousError(RuntimeError):
    """Multi-process initialization failed (peer missing / coordinator
    down)."""


def _backoff_delay(attempt: int, rank: int, *, base_s: float,
                   cap_s: float = BACKOFF_CAP_S) -> float:
    """Exponential backoff with deterministic per-(rank, attempt) jitter in
    [0.5x, 1.5x): the JAX package's delays, draw for draw."""
    delay = min(base_s * (2.0 ** attempt), cap_s)
    jitter = np.random.default_rng(7919 * rank + attempt).random()
    return delay * (0.5 + jitter)


def backend_for(device: torch.device) -> str:
    """The process-group backend of ``device``: NCCL on the card, Gloo on
    the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def bind_device(device: str | torch.device = "cuda",
                local_rank: int | None = None) -> torch.device:
    """Resolve ``device`` for this process: on ``cuda`` without an index,
    ``cuda:{local_rank}`` (``LOCAL_RANK``, else 0), made current before any
    CUDA tensor exists."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local_rank)
    torch.cuda.set_device(dev)
    return dev


def init_distributed(
    master_ip: str | None = None,
    num_nodes: int = 1,
    rank: int = 0,
    *,
    port: int = DEFAULT_PORT,
    timeout_s: int | None = DEFAULT_TIMEOUT_S,
    connect_attempts: int | None = None,
    backoff_base_s: float = BACKOFF_BASE_S,
    backoff_cap_s: float | None = None,
    device: str | torch.device = "cuda",
    local_rank: int | None = None,
    _initialize=None,
) -> torch.device:
    """Explicit-rendezvous mode (reference main_all_reduce.py:96 contract):
    ``init_process_group(backend, 'tcp://{master_ip}:{port}', num_nodes,
    rank)``.  Returns this process's device (``cuda:{local_rank}`` on the
    card).

    No group for ``num_nodes == 1``, as in the JAX package.  A failed dial
    is retried up to ``connect_attempts`` times (default:
    ``JAX_GRAFT_RDZV_ATTEMPTS``, else 5) within ``timeout_s`` in all, each
    delay capped at ``backoff_cap_s`` (default:
    ``JAX_GRAFT_RDZV_BACKOFF_CAP_S``, else 30 s); ``_initialize`` is a test
    seam (defaults to ``torch.distributed.init_process_group``)."""
    dev = bind_device(device, local_rank)
    if num_nodes <= 1:
        return dev
    if master_ip is None:
        raise ValueError("--master-ip is required when --num-nodes > 1")
    if connect_attempts is None:
        connect_attempts = rdzv_attempts_from_env()
    if backoff_cap_s is None:
        backoff_cap_s = rdzv_backoff_cap_from_env()
    coordinator = f"{master_ip}:{port}"
    initialize = _initialize if _initialize is not None else (
        dist.init_process_group)
    total_s = timeout_s if timeout_s else 86_400
    deadline = time.monotonic() + total_s
    last: Exception | None = None
    attempts = max(connect_attempts, 1)
    backend = backend_for(dev)
    for attempt in range(attempts):
        remaining = deadline - time.monotonic()
        if remaining <= 0 and attempt > 0:
            break
        try:
            initialize(
                backend=backend,
                init_method=f"tcp://{coordinator}",
                world_size=num_nodes,
                rank=rank,
                timeout=datetime.timedelta(seconds=max(int(remaining), 1)),
                **({"device_id": dev} if dev.type == "cuda" else {}))
            print(f"[rendezvous] rank {rank}/{num_nodes}: connected to "
                  f"{coordinator} ({backend}) after {attempt + 1}/"
                  f"{attempts} attempt(s)", flush=True)
            return dev
        except Exception as e:  # noqa: BLE001 - every dial failure retries
            last = e
            if attempt + 1 >= attempts:
                break
            delay = _backoff_delay(attempt, rank, base_s=backoff_base_s,
                                   cap_s=backoff_cap_s)
            print(f"[rendezvous] rank {rank}: attempt {attempt + 1}/"
                  f"{attempts} to {coordinator} failed ({e}); "
                  f"retrying in {delay:.2f}s", flush=True)
            time.sleep(delay)
    raise RendezvousError(
        f"rendezvous with coordinator {coordinator} failed for rank "
        f"{rank}/{num_nodes} after {attempts} attempts "
        f"within the {total_s}s budget: {last}") from last


def init_from_env(*, timeout_s: int | None = DEFAULT_TIMEOUT_S,
                  device: str | torch.device = "cuda") -> torch.device:
    """Env-var rendezvous mode (the torchrun convention, main_ddp.py:93-104):
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, and LOCAL_RANK for the
    card.  Missing vars mean one process, as in the JAX package."""
    return init_distributed(
        os.environ.get("MASTER_ADDR"),
        int(os.environ.get("WORLD_SIZE", "1")),
        int(os.environ.get("RANK", "0")),
        port=int(os.environ.get("MASTER_PORT", str(DEFAULT_PORT))),
        timeout_s=timeout_s, device=device)


def shutdown() -> None:
    """Destroy the default process group (and with it every subgroup), if
    one exists."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """(rank, world_size) of this process; (0, 1) with no group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
