"""Data-parallel invariants: the port of ``assert_replicas_in_sync`` and
``assert_finite`` of the JAX package's utils/debug.py.  The JAX replicas
are devices of one process; here they are the ranks of a process group, so
the comparison is a collective every rank calls.  The rest of the JAX
module (schedule inspection, determinism checks) belongs to slice 5f.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.strategies import all_gather_flat


class ConsistencyError(AssertionError):
    """A data-parallel invariant does not hold."""


def _leaves(tree: dict) -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) of a nested dict of tensors, in insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += [(f"{k}.{p}", t) for p, t in _leaves(v)]
        else:
            out.append((k, v))
    return out


def assert_replicas_in_sync(tree: dict, group=None, *,
                            what: str = "training state") -> None:
    """Raise unless every tensor of ``tree`` holds the same bits on every
    rank of ``group``.  All ranks must call it: each rank's bytes are
    all-gathered (one collective) and compared with rank 0's."""
    leaves = _leaves(tree)
    flat = torch.cat([t.detach().contiguous().reshape(-1)
                      .view(torch.uint8) for _, t in leaves])
    n = dist.get_world_size(group)
    gathered = torch.empty(n * flat.numel(), dtype=flat.dtype,
                           device=flat.device)
    all_gather_flat(gathered, flat, group=group)
    gathered = gathered.view(n, -1)
    bad, offset = [], 0
    for path, t in leaves:
        nb = t.numel() * t.element_size()
        rows = gathered[:, offset:offset + nb]
        if not bool((rows == rows[:1]).all()):
            bad.append(path)
        offset += nb
    if bad:
        raise ConsistencyError(
            f"{what} desynced across replicas at {len(bad)} leaves: "
            f"{bad[:5]}{'...' if len(bad) > 5 else ''}")


def assert_finite(tree: dict, *, what: str = "pytree") -> None:
    """Raise if any floating tensor of ``tree`` holds NaN or Inf."""
    bad = [path for path, t in _leaves(tree)
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    if bad:
        raise ConsistencyError(
            f"{what} has non-finite values at {len(bad)} leaves: "
            f"{bad[:5]}{'...' if len(bad) > 5 else ''}")
