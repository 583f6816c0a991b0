"""Checkpoint / resume: the port of the JAX package's utils/checkpoint.py,
its four checkpointers and their container.

The files are the JAX package's: ``ckpt_<n>.npz`` holding every leaf and a
``__meta__`` entry (uint8 JSON) whose ``__checksums__`` table has each
leaf's ``_crc`` (crc32 over ``str(dtype)``, ``str(shape)`` and the bytes);
``ckpt_<step>/proc<k>.npz`` with ``proc<k>.idx.json`` (each saved piece's
global slice and crc) and ``meta.json``, written last by rank 0 after a
barrier, for the sharded format; ``inc_<step>.npz`` with
``manifest_<step>.json`` for the incremental one.  Writes are atomic (tmp +
rename); a generation that fails verification is quarantined (renamed
``*.corrupt``, uniquified) and the restore falls back to the previous one.
Leaf keys are the port's own names, ``<tree>/<key>/<key>...`` (for example
``params/layers.0.wq``, ``opt/mu/layers.0.wq``, ``params/conv0/kernel``):
a port checkpoint restores into the port and a JAX one into the JAX
package, while either package's ``_load_npz_verified`` reads the other's
archives.

Trees are nested dicts whose leaves are tensors, numpy arrays, Python ints
(saved as 0-d int64 arrays and given back as ints) or None (not saved: a
momentum buffer that does not exist yet).  A leaf numpy cannot hold (a
bfloat16 tensor) raises; no trainer state is bfloat16.

- ``_fetch`` returns an OWNED host copy: on the CPU ``tensor.numpy()`` is a
  view of the live buffer, which the trainers' in-place optimizer updates
  would rewrite while the background writer serializes it.
- Whole-tree checkpointers take whole values: a trainer gathers its shards
  first (every rank takes part), and rank 0 alone writes.
- ``ShardedCheckpointer`` takes ``Shard`` leaves, each process's piece of a
  global array with its global slice (a ZeRO-3 shard is a ``narrow`` along
  its dim); a plain tensor is a whole value every process holds, written
  once, by rank 0.  Restores cut each template piece from the saved pieces
  that intersect it.
- ``async_write``: the device-to-host fetch stays synchronous (it must see
  a settled state) while the checksums, serialization and disk IO run on a
  background thread, one write in flight per directory.

Checkpoint IO lands on the telemetry timeline as ``ckpt_save`` /
``ckpt_restore`` / ``ckpt_reshard`` spans in the ``ckpt`` lane, with a
``host_rss_bytes`` gauge beside each.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib
from dataclasses import dataclass

import numpy as np

from . import faults, monitor, telemetry

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")
SEP = "/"  # joins the tree's name and its dict keys into a leaf key


def _tel_span(name: str, t0: float, **args) -> None:
    """Checkpoint IO as a span in the 'ckpt' lane, with the host RSS gauge
    beside it (checkpoint IO is where host memory peaks), when telemetry
    is on; one registry read otherwise."""
    tel = telemetry.active()
    if tel is not None:
        tel.span_at(name, t0, time.perf_counter() - t0, phase="ckpt",
                    **args)
        tel.gauge("host_rss_bytes", monitor.host_rss_bytes(),
                  phase="mem", at=name)


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed integrity verification (checksum mismatch,
    truncated archive, missing leaves).  Restores catch it, QUARANTINE the
    generation (rename to ``*.corrupt``) and fall back to the previous
    one."""


def _crc(arr: np.ndarray) -> int:
    """crc32 over dtype, shape and bytes: the per-leaf integrity tag,
    written at save and verified at load (bit rot and truncation, not an
    adversary).  The JAX package's value, read from the array's buffer
    without the copy ``tobytes`` makes."""
    h = zlib.crc32(str(arr.dtype).encode())
    h = zlib.crc32(str(arr.shape).encode(), h)
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8),
                      h)


def _verify_flat(flat: dict, meta: dict, path: str) -> None:
    """Check every leaf against the meta's checksum table (a checkpoint
    without one passes: nothing to verify against)."""
    sums = meta.get("__checksums__")
    if sums is None:
        return
    missing = [k for k in sums if k not in flat]
    if missing:
        raise CorruptCheckpointError(
            f"checkpoint {path} is missing {len(missing)} leaves "
            f"(e.g. {missing[:3]})")
    bad = [k for k, want in sums.items() if _crc(flat[k]) != want]
    if bad:
        raise CorruptCheckpointError(
            f"checkpoint {path} failed checksum verification at "
            f"{len(bad)} leaves (e.g. {bad[:3]})")


def _load_npz_verified(path: str) -> tuple[dict, dict]:
    """Read one whole-tree npz and its embedded meta, verified;
    CorruptCheckpointError for an unreadable or truncated archive or a
    checksum mismatch."""
    try:
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        meta = json.loads(bytes(flat.pop("__meta__").tobytes()).decode())
    except CorruptCheckpointError:
        raise
    except Exception as e:  # zipfile/EOF/pickle/json: unreadable archive
        raise CorruptCheckpointError(
            f"checkpoint {path} is unreadable: {e}") from e
    _verify_flat(flat, meta, path)
    return flat, meta


def _quarantine(path: str, err: Exception, log=print) -> None:
    """Move a corrupt checkpoint aside (``<path>.corrupt``, uniquified on
    collision: a generation index is reused after a rollback re-saves it)
    so it stops listing; never raises."""
    dest = path + ".corrupt"
    for n in range(1, 100):
        if not os.path.exists(dest):
            break
        dest = f"{path}.corrupt.{n}"
    try:
        os.replace(path, dest)
    except OSError:
        pass
    if log:
        log(f"[checkpoint] quarantined corrupt checkpoint {path}: {err}")


class _AsyncWriter:
    """At most one background write in flight; join-before-submit.
    Shared per directory (``_writer_for``), so every checkpointer on one
    path serializes against the same write; a background failure is
    re-raised from the next ``wait`` / ``submit``."""

    def __init__(self):
        self._t: threading.Thread | None = None
        self._exc: BaseException | None = None
        self._lock = threading.Lock()

    def submit(self, fn) -> None:
        with self._lock:
            self._wait_locked()

            def run():
                try:
                    fn()
                except BaseException as e:  # noqa: BLE001 - re-raised in wait
                    self._exc = e

            self._t = threading.Thread(target=run)  # non-daemon: exit flushes
            self._t.start()

    def wait(self) -> None:
        with self._lock:
            self._wait_locked()

    def _wait_locked(self) -> None:
        if self._t is not None:
            self._t.join()
            self._t = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("background checkpoint write failed") from exc


_WRITERS: dict[str, _AsyncWriter] = {}
_WRITERS_LOCK = threading.Lock()


def _writer_for(directory: str) -> _AsyncWriter:
    key = os.path.abspath(directory)
    with _WRITERS_LOCK:
        return _WRITERS.setdefault(key, _AsyncWriter())


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


@dataclass
class Shard:
    """One process's piece of a global array: ``data`` is ``global[index]``
    of a ``shape``-shaped array (``index`` a tuple of slices, one a dim).
    ``replica`` > 0 marks a copy another process also holds: each global
    element is written once, by its replica 0."""
    data: object  # torch.Tensor
    shape: tuple
    index: tuple
    replica: int = 0


def full_index(shape) -> tuple:
    return tuple(slice(0, d) for d in shape)


def _fetch(leaf, key: str = "") -> np.ndarray:
    """An OWNED host copy of a leaf: a tensor's values (a device tensor's
    copy to the host; a CPU tensor cloned, since ``.numpy()`` would view
    the live buffer), a numpy array copied, a Python int as a 0-d int64
    array.  TypeError for a dtype numpy cannot hold."""
    import torch
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        host = t.cpu()
        if host.data_ptr() == t.data_ptr():
            host = host.clone()
        try:
            return host.numpy()
        except TypeError as e:
            raise TypeError(
                f"checkpoint leaf {key!r} has dtype {t.dtype}, which numpy "
                f"cannot hold (trainer state is float32)") from e
    if isinstance(leaf, (bool, int, np.integer)):
        return np.asarray(int(leaf), dtype=np.int64)
    return np.array(leaf, copy=True)


def _leaves(tree, prefix: str):
    """``(key, leaf)`` of a nested dict, keys ``prefix/k1/k2...``; a
    non-dict is one leaf under ``prefix``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{SEP}{k}")
    else:
        yield prefix, tree


def _flatten(trees: dict) -> dict[str, np.ndarray]:
    """Every leaf of ``{name: tree}`` fetched to the host, None skipped."""
    return {key: _fetch(leaf, key) for name, tree in trees.items()
            for key, leaf in _leaves(tree, name) if leaf is not None}


def _place(arr: np.ndarray, leaf, key: str):
    """A saved value in the template leaf's form: a tensor on its device,
    of its dtype and ``requires_grad``; an int; a numpy array; a
    ``Shard``'s piece cut from the whole value."""
    import torch
    if isinstance(leaf, Shard):
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(arr.shape)}, template expects "
                             f"{tuple(leaf.shape)}")
        return _place(np.ascontiguousarray(arr[leaf.index]), leaf.data, key)
    if isinstance(leaf, torch.Tensor):
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(arr.shape)}, model expects "
                             f"{tuple(leaf.shape)}")
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=leaf.device, dtype=leaf.dtype)
        return t.requires_grad_(leaf.requires_grad)
    if isinstance(leaf, (bool, int, np.integer)):
        return int(arr)
    arr = np.asarray(arr)
    if arr.shape != np.shape(leaf):
        raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                         f"model expects {np.shape(leaf)}")
    return arr.astype(np.asarray(leaf).dtype)


def _unflatten_like(tree, flat: dict, prefix: str):
    """``tree``'s structure with each leaf taken from ``flat`` (KeyError
    for a missing one; a None leaf stays None)."""
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{SEP}{k}")
                for k, v in tree.items()}
    if tree is None:
        return None
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    return _place(flat[prefix], tree, prefix)


def _place_like(like: dict, flat: dict) -> dict:
    return {name: _unflatten_like(tree, flat, name)
            for name, tree in like.items()}


def _list_ckpts(directory: str) -> list[tuple[int, str]]:
    out = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def _atomic_write(directory: str, index: int, payload: dict,
                  meta: dict, keep: int) -> str:
    """Embed meta and per-leaf checksums, write ckpt_<index>.npz
    atomically, prune old ones."""
    t0 = time.perf_counter()
    nbytes = sum(v.nbytes for v in payload.values())
    payload = dict(payload)
    meta = dict(meta, __checksums__={k: _crc(v) for k, v in
                                     payload.items()})
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    path = os.path.join(directory, f"ckpt_{index}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic publish
    faults.maybe_corrupt_checkpoint(path)  # chaos hook (no-op unplanned)
    for _, old in _list_ckpts(directory)[:-keep]:
        os.remove(old)
    _tel_span("ckpt_save", t0, step=int(index), bytes=int(nbytes),
              fmt="npz")
    return path


def _copy_into(live, flat: dict, prefix: str) -> None:
    """Copy the saved leaves into the live tensors of ``live`` in place
    (the VGG params, which the optimizer holds by reference)."""
    import torch
    for key, t in _leaves(live, prefix):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(arr.shape)}, model expects "
                             f"{tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))


def _stack_rows(tree: dict, group) -> dict:
    """Every rank's leaves of a nested dict stacked on a leading axis
    (rank order), one all-gather of the flattened tree; numpy arrays."""
    import torch
    import torch.distributed as dist
    from ..parallel import strategies as strat
    leaves = [(k, t) for k, t in _leaves(tree, "") if t is not None]
    if not leaves:
        return {}
    flat = torch.cat([t.detach().reshape(-1).float() for _, t in leaves])
    n = dist.get_world_size(group)
    out = torch.empty(n * flat.numel(), dtype=flat.dtype,
                      device=flat.device)
    strat.all_gather_flat(out, flat, group=group)
    rows = _fetch(out).reshape(n, -1)
    res, off = {}, 0
    for key, t in leaves:
        res[key] = rows[:, off:off + t.numel()].reshape(
            (n,) + tuple(t.shape))
        off += t.numel()
    return res


class Checkpointer:
    """Epoch-granularity checkpoints of the VGG trainer in ``directory``
    (ckpt_<epoch>.npz): params, BN state and the SGD momentum buffers."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._writer = _writer_for(directory)
        os.makedirs(directory, exist_ok=True)

    def wait(self) -> None:
        """Block until any in-flight background write has been published."""
        self._writer.wait()

    # -- save -------------------------------------------------------------
    def save(self, trainer, epoch: int) -> str | None:
        """Snapshot the trainer after ``epoch`` completed epochs.

        Every rank must call it: under a mesh each rank's BN state is
        gathered and stacked on a leading replica axis (as the JAX
        trainer holds it), as is each rank's momentum under sync windows;
        rank 0 alone writes the file."""
        group = trainer.group if trainer.mesh is not None else None
        stacked_opt = trainer.mesh is not None and trainer.cfg.sync_every > 1
        state = (_stack_rows(trainer.state, group)
                 if trainer.mesh is not None else None)
        mom = trainer.opt_state
        opt = (_stack_rows(mom, group) if stacked_opt else None)
        if _rank() != 0:
            return None
        payload = _flatten({"params": trainer.params})
        if state is None:
            payload.update(_flatten({"state": trainer.state}))
        else:
            payload.update({"state" + k: v for k, v in state.items()})
        if opt is None:
            payload.update(_flatten({"opt": mom}))
        else:
            payload.update({"opt" + k: v for k, v in opt.items()})
        meta = {"epoch": epoch, "step": trainer._step,
                "model": trainer.cfg.model, "strategy": trainer.cfg.strategy,
                "n_replicas": trainer.n_replicas,
                # mesh trainers stack BN state on a leading replica axis;
                # the single-device trainer stores it bare
                "stacked_state": trainer.mesh is not None,
                "stacked_opt": stacked_opt}
        path = os.path.join(self.directory, f"ckpt_{epoch}.npz")
        if self.async_write:
            self._writer.submit(lambda: _atomic_write(
                self.directory, epoch, payload, meta, self.keep))
            return path
        return _atomic_write(self.directory, epoch, payload, meta, self.keep)

    # -- restore ----------------------------------------------------------
    def list(self) -> list[tuple[int, str]]:
        self._writer.wait()  # reads must see the settled directory
        return _list_ckpts(self.directory)

    def latest(self) -> tuple[int, str] | None:
        ckpts = self.list()
        return ckpts[-1] if ckpts else None

    def maybe_restore(self, trainer) -> int:
        """Restore the latest verified checkpoint into ``trainer`` if one
        exists; returns the epoch to resume from (0 = fresh start).

        Cross-topology: a checkpoint written at another world size (or
        without a mesh) restores onto this trainer's; params and momentum
        are replicated, and the replica-stacked BN state takes rank 0's
        running stats on every rank (torch DDP's buffer-broadcast
        convention; each rank's own when the topology matches).  A
        momentum buffer the checkpoint lacks (none existed yet) is put back
        to none.  A corrupt generation is quarantined and the restore
        falls back to the previous one."""
        import torch
        t0 = time.perf_counter()
        got = None
        for epoch, path in reversed(self.list()):
            try:
                flat, meta = _load_npz_verified(path)
            except CorruptCheckpointError as e:
                _quarantine(path, e)
                continue
            got = (epoch, flat, meta)
            break
        if got is None:
            return 0
        epoch, flat, meta = got
        if meta["model"] != trainer.cfg.model:
            raise ValueError(
                f"checkpoint is for model {meta['model']}, "
                f"trainer is {trainer.cfg.model}")
        _copy_into(trainer.params, flat, "params")
        saved_stacked = meta.get("stacked_state", meta["strategy"] != "none")
        same = (meta["n_replicas"] == trainer.n_replicas
                and saved_stacked == (trainer.mesh is not None))
        row = trainer.rank if same else 0

        def take(k, stacked):
            v = flat[k]
            return v[row] if stacked else v

        dev = trainer.device
        trainer.state = {
            k: {n: torch.from_numpy(np.ascontiguousarray(take(
                f"state{SEP}{k}{SEP}{n}", saved_stacked))).to(dev)
                for n in v} for k, v in trainer.state.items()}
        stacked_opt = meta.get("stacked_opt", False)
        mom = {k: {n: (torch.from_numpy(np.ascontiguousarray(take(
            key, stacked_opt))).to(dev) if key in flat else None)
            for n in v for key in [f"opt{SEP}momentum{SEP}{k}{SEP}{n}"]}
            for k, v in trainer.params.items()}
        trainer.opt_state = {"momentum": mom}
        trainer._step = meta["step"]
        _tel_span("ckpt_restore", t0, step=int(meta["step"]),
                  bytes=int(sum(v.nbytes for v in flat.values())),
                  fmt="npz")
        return meta["epoch"]


class PyTreeCheckpointer:
    """Step-granularity checkpoints of named trees (the LM trainer's).

    ``save`` stores a dict of whole trees and JSON-able meta (rank 0
    writes; the others return None); ``restore`` needs a template dict of
    the same structure and gives each leaf the template leaf's form
    (device, dtype, ``requires_grad``, a ``Shard``'s piece)."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._writer = _writer_for(directory)
        os.makedirs(directory, exist_ok=True)

    def wait(self) -> None:
        """Block until any in-flight background write has been published."""
        self._writer.wait()

    def save(self, trees: dict, step: int, meta: dict | None = None):
        if _rank() != 0:
            return None
        payload = _flatten(trees)
        full_meta = dict(meta or {}, step=step)
        path = os.path.join(self.directory, f"ckpt_{step}.npz")
        if self.async_write:
            self._writer.submit(lambda: _atomic_write(
                self.directory, step, payload, full_meta, self.keep))
            return path
        return _atomic_write(self.directory, step, payload, full_meta,
                             self.keep)

    def list(self) -> list[tuple[int, str]]:
        self._writer.wait()  # reads must see the settled directory
        return _list_ckpts(self.directory)

    def restore(self, like: dict) -> tuple[dict, dict] | None:
        """The latest VERIFIED checkpoint in ``like``'s structure, as
        ``(trees, meta)``, or None when none exists; corrupt generations
        are quarantined and skipped."""
        t0 = time.perf_counter()
        for _, path in reversed(self.list()):
            try:
                flat, meta = _load_npz_verified(path)
            except CorruptCheckpointError as e:
                _quarantine(path, e)
                continue
            out = _place_like(like, flat), meta
            _tel_span("ckpt_restore", t0, step=int(meta.get("step", -1)),
                      bytes=int(sum(v.nbytes for v in flat.values())),
                      fmt="npz")
            return out
        return None


# ---------------------------------------------------------------------------
# Sharded (per-process) checkpoints
# ---------------------------------------------------------------------------

def _slices_to_json(index, shape) -> list[list[int]]:
    return [[s.start or 0, s.stop if s.stop is not None else dim]
            for s, dim in zip(index, shape)]


def _overlap(target: list[tuple[int, int]],
             saved: list[tuple[int, int]]) -> tuple | None:
    """Intersection of two global index boxes as (target-local slices,
    saved-local slices), or None when they do not overlap."""
    tgt_sl, src_sl = [], []
    for (ta, tb), (sa, sb) in zip(target, saved):
        lo, hi = max(ta, sa), min(tb, sb)
        if lo >= hi:
            return None
        tgt_sl.append(slice(lo - ta, hi - ta))
        src_sl.append(slice(lo - sa, hi - sa))
    return tuple(tgt_sl), tuple(src_sl)


def _cut_target(key: str, entries: list, read,
                target: list[tuple[int, int]], dtype) -> np.ndarray:
    """Rebuild ONE target piece from the saved entries that intersect it:
    only overlapping chunks are read, and nothing the size of the full
    array is allocated; coverage is verified by element count (saved
    pieces never overlap)."""
    shape = tuple(b - a for a, b in target)
    out = None
    covered = 0
    for e in entries:
        if e["slices"] is None:
            whole = np.asarray(read(e))
            return np.ascontiguousarray(
                whole[tuple(slice(a, b) for a, b in target)]).astype(
                    dtype, copy=False)
        hit = _overlap(target, [tuple(s) for s in e["slices"]])
        if hit is None:
            continue
        tgt_sl, src_sl = hit
        chunk = read(e)
        if out is None:
            out = np.zeros(shape, chunk.dtype)
        out[tgt_sl] = chunk[src_sl]
        covered += int(np.prod([s.stop - s.start for s in tgt_sl]))
    size = int(np.prod(shape)) if shape else 1
    if out is None or covered != size:
        raise ValueError(
            f"leaf {key!r}: saved shards cover {covered} of {size} "
            f"target elements — checkpoint incomplete for this layout "
            f"(missing process files?)")
    return out


def _assemble(key: str, entries: list, read, shape: tuple) -> np.ndarray:
    """A full array from its saved slice entries (the cross-layout
    fallback), coverage verified by element count; a ``slices=None``
    entry is a whole value by itself."""
    for e in entries:
        if e["slices"] is None:
            return np.asarray(read(e)).reshape(shape)
    first = read(entries[0])
    full = np.zeros(shape, first.dtype)
    covered = 0
    for e in entries:
        sl = tuple(slice(a, b) for a, b in e["slices"])
        chunk = read(e)
        full[sl] = chunk
        covered += chunk.size
    if covered != full.size:
        raise ValueError(
            f"leaf {key!r}: saved shards cover {covered} of {full.size} "
            f"elements — checkpoint incomplete (missing process files?)")
    return full


def _as_shard(leaf):
    """A tensor template or value as the ``Shard`` it is on this process:
    a plain tensor is a whole value every rank holds (rank 0 writes it)."""
    import torch
    if isinstance(leaf, torch.Tensor):
        return Shard(leaf, tuple(leaf.shape), full_index(leaf.shape),
                     replica=_rank())
    return leaf


class ShardedCheckpointer:
    """Per-shard checkpoints: every process writes ONLY its own pieces (no
    gather, no full-tree host copy), so checkpoint memory and IO scale
    with the per-process shard.

    Layout: ``directory/ckpt_<step>/`` holds ``proc<k>.npz`` (the pieces)
    and ``proc<k>.idx.json`` (each piece's global slice, shape and crc) a
    process, and ``meta.json``, written last by rank 0 after a barrier
    (its presence marks the checkpoint complete).  A piece held by several
    processes is written once (``Shard.replica == 0``).

    ``restore`` matches each template piece's global slice against the
    saved index: an exact hit moves only that piece's bytes; a layout that
    differs assembles the leaf on the host and cuts the piece.
    ``load_resharded`` cuts each target piece from the saved chunks that
    intersect it and never builds a full array."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        # accounting of the newest restore/load_resharded (the reshard
        # tests pin full_assemblies == 0 on the resharding path)
        self.last_reshard_stats: dict | None = None
        os.makedirs(directory, exist_ok=True)

    def wait(self) -> None:
        """No-op: shard writes are synchronous (interface symmetry with the
        async whole-tree checkpointer)."""

    # -- save -------------------------------------------------------------
    def save(self, trees: dict, step: int, meta: dict | None = None) -> str:
        """Every process calls it with its own ``Shard`` leaves (and the
        whole values: plain tensors, ints); returns the step's
        directory."""
        t0 = time.perf_counter()
        pid, nprocs = _rank(), _world()
        ckpt_dir = os.path.join(self.directory, f"ckpt_{step}")
        os.makedirs(ckpt_dir, exist_ok=True)
        if pid == 0:
            # re-saving a step: drop the completion marker first, so a crash
            # mid-rewrite cannot leave a mixed checkpoint listed complete
            try:
                os.remove(os.path.join(ckpt_dir, "meta.json"))
            except FileNotFoundError:
                pass
        _barrier()  # no process overwrites a piece while the marker stands
        payload: dict[str, np.ndarray] = {}
        index: dict[str, list] = {}
        for name, tree in trees.items():
            for key, leaf in _leaves(tree, name):
                if leaf is None:
                    continue
                leaf = _as_shard(leaf)
                if not isinstance(leaf, Shard):
                    if pid == 0:
                        arr = _fetch(leaf, key)
                        payload[f"{key}#0"] = arr
                        index[key] = [{"npz": f"{key}#0", "slices": None,
                                       "shape": list(arr.shape),
                                       "crc": _crc(arr)}]
                    continue
                if leaf.replica != 0:
                    continue  # dedupe replicated copies
                data = _fetch(leaf.data, key)
                payload[f"{key}#0"] = data
                index[key] = [{
                    "npz": f"{key}#0",
                    "slices": _slices_to_json(leaf.index, leaf.shape),
                    "shape": list(leaf.shape),
                    "crc": _crc(data),
                }]
        tmp = os.path.join(ckpt_dir, f"proc{pid}.npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, os.path.join(ckpt_dir, f"proc{pid}.npz"))
        with open(os.path.join(ckpt_dir, f"proc{pid}.idx.json.tmp"),
                  "w") as f:
            json.dump(index, f)
        os.replace(os.path.join(ckpt_dir, f"proc{pid}.idx.json.tmp"),
                   os.path.join(ckpt_dir, f"proc{pid}.idx.json"))
        faults.maybe_corrupt_checkpoint(
            os.path.join(ckpt_dir, f"proc{pid}.npz"))
        _barrier()
        if pid == 0:
            with open(os.path.join(ckpt_dir, "meta.json.tmp"), "w") as f:
                json.dump(dict(meta or {}, step=step, nprocs=nprocs), f)
            os.replace(os.path.join(ckpt_dir, "meta.json.tmp"),
                       os.path.join(ckpt_dir, "meta.json"))
            self._prune()
        _tel_span("ckpt_save", t0, step=int(step),
                  bytes=int(sum(v.nbytes for v in payload.values())),
                  fmt="sharded")
        return ckpt_dir

    def _prune(self) -> None:
        for _, path in self.list()[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def list(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if (name.startswith("ckpt_") and name[5:].isdigit()
                    and os.path.exists(os.path.join(full, "meta.json"))):
                out.append((int(name[5:]), full))
        return sorted(out)

    def restore(self, like: dict) -> tuple[dict, dict] | None:
        """The latest complete VERIFIED checkpoint in ``like``'s structure,
        each template piece rebuilt onto its device, as ``(trees, meta)``;
        None when none exists.  A generation with a corrupt piece or
        metadata is quarantined and the restore falls back."""
        for _, ckpt_dir in reversed(self.list()):
            try:
                return self._restore_dir(ckpt_dir, like)
            except CorruptCheckpointError as e:
                _quarantine(ckpt_dir, e)
        return None

    def load_resharded(self, like: dict) -> tuple[dict, dict] | None:
        """Cross-topology restore: the SAVED pieces mapped onto ``like``'s
        (possibly different) layout leaf by leaf, each target piece cut
        from exactly the saved chunks that intersect it, the chunks
        dropped once their leaf is placed.  The same verification,
        quarantine and fall-back as ``restore``, and the same values.
        Accounting lands in ``self.last_reshard_stats`` (exact_hits /
        intersections / full_assemblies, pinned 0 here / read_bytes /
        peak_leaf_read_bytes)."""
        for _, ckpt_dir in reversed(self.list()):
            try:
                return self._restore_dir(ckpt_dir, like, reshard=True)
            except CorruptCheckpointError as e:
                _quarantine(ckpt_dir, e)
        return None

    def _restore_dir(self, ckpt_dir: str, like: dict,
                     reshard: bool = False) -> tuple[dict, dict]:
        t_restore = time.perf_counter()

        def read_json(path: str):
            try:
                with open(path) as f:
                    return json.load(f)
            except (OSError, ValueError, UnicodeDecodeError) as e:
                raise CorruptCheckpointError(
                    f"checkpoint metadata {path} is unreadable: {e}") from e

        meta = read_json(os.path.join(ckpt_dir, "meta.json"))
        index: dict[str, list] = {}
        files: dict[int, np.lib.npyio.NpzFile] = {}
        for k in range(meta.get("nprocs", 1)):
            idx_path = os.path.join(ckpt_dir, f"proc{k}.idx.json")
            if not os.path.exists(idx_path):
                continue
            for key, entries in read_json(idx_path).items():
                for e in entries:
                    e["proc"] = k
                index.setdefault(key, []).extend(entries)
            npz_path = os.path.join(ckpt_dir, f"proc{k}.npz")
            try:
                files[k] = np.load(npz_path)
            except Exception as e:  # truncated/unreadable archive
                raise CorruptCheckpointError(
                    f"shard file {npz_path} is unreadable: {e}") from e

        loaded: dict[tuple, np.ndarray] = {}
        stats = {"leaves": 0, "exact_hits": 0, "intersections": 0,
                 "full_assemblies": 0, "read_bytes": 0,
                 "peak_leaf_read_bytes": 0}

        def read(e) -> np.ndarray:
            """One saved piece, decompressed once and crc-verified on its
            first read."""
            k = (e["proc"], e["npz"])
            if k not in loaded:
                try:
                    arr = files[e["proc"]][e["npz"]]
                except Exception as err:
                    raise CorruptCheckpointError(
                        f"shard {e['npz']} of proc{e['proc']} in "
                        f"{ckpt_dir} is unreadable: {err}") from err
                want = e.get("crc")
                if want is not None and _crc(arr) != want:
                    raise CorruptCheckpointError(
                        f"shard {e['npz']} of proc{e['proc']} in "
                        f"{ckpt_dir} failed checksum verification")
                loaded[k] = arr
                stats["read_bytes"] += arr.nbytes
            return loaded[k]

        def place(key: str, leaf):
            if key not in index:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            entries = index[key]
            stats["leaves"] += 1
            leaf_read0 = stats["read_bytes"]
            leaf = _as_shard(leaf)
            shape = leaf.shape if isinstance(leaf, Shard) else tuple(
                np.shape(leaf))
            saved_shape = entries[0].get("shape")
            if saved_shape is not None and tuple(saved_shape) != tuple(
                    shape):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape "
                    f"{tuple(saved_shape)}, template expects {tuple(shape)}")
            if not isinstance(leaf, Shard):
                return _place(_assemble(key, entries, read, tuple(shape)),
                              leaf, key)
            want = tuple(map(tuple, _slices_to_json(leaf.index, shape)))
            by_slices = {tuple(map(tuple, e["slices"])): e
                         for e in entries if e["slices"] is not None}
            e = by_slices.get(want)
            if e is not None:
                # exact layout hit: only this piece's bytes move
                data = read(e)
                stats["exact_hits"] += 1
            elif reshard:
                # cross-topology: the piece cut from exactly the saved
                # chunks intersecting it; the full array is never built
                data = _cut_target(key, entries, read,
                                   [list(w) for w in want],
                                   _fetch_dtype(leaf.data))
                stats["intersections"] += 1
            else:
                full = _assemble(key, entries, read, tuple(shape))
                stats["full_assemblies"] += 1
                data = full[leaf.index]
            out = _place(np.asarray(data), leaf.data, key)
            if reshard:
                # one in-flight leaf: drop this leaf's host chunks
                stats["peak_leaf_read_bytes"] = max(
                    stats["peak_leaf_read_bytes"],
                    stats["read_bytes"] - leaf_read0)
                loaded.clear()
            return out

        def walk(tree, prefix: str):
            if isinstance(tree, dict):
                return {k: walk(v, f"{prefix}{SEP}{k}")
                        for k, v in tree.items()}
            return None if tree is None else place(prefix, tree)

        try:
            out = {name: walk(tree, name) for name, tree in like.items()}
        finally:
            for z in files.values():
                z.close()
        self.last_reshard_stats = stats
        _tel_span("ckpt_reshard" if reshard else "ckpt_restore",
                  t_restore, step=int(meta.get("step", -1)),
                  bytes=int(stats["read_bytes"]), fmt="sharded",
                  exact_hits=stats["exact_hits"],
                  intersections=stats["intersections"])
        return out, meta


def _fetch_dtype(t) -> np.dtype:
    """The numpy dtype of a tensor's elements (float32 for the trainers'
    state)."""
    import torch
    return torch.empty(0, dtype=t.dtype).numpy().dtype


# ---------------------------------------------------------------------------
# Incremental (content-hashed) checkpoints
# ---------------------------------------------------------------------------

class IncrementalCheckpointer:
    """Content-hashed incremental checkpoints: each ``save`` writes ONLY the
    leaves whose bytes changed since the previous save, plus a manifest
    mapping every leaf to the delta file that holds its current bytes.

    Layout: ``directory/inc_<step>.npz`` (changed leaves only) and
    ``directory/manifest_<step>.json``, written last and atomically, so its
    presence marks the step complete.  Whole-state saves see no size win
    (Adam moments and momentum change every step); frozen-leaf saves do.
    ``keep`` retains the newest N manifests; a delta file a retained
    manifest cites survives garbage collection regardless of age."""

    _MANIFEST_RE = re.compile(r"^manifest_(\d+)\.json$")

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._writer = _writer_for(directory)
        os.makedirs(directory, exist_ok=True)
        self._last: dict[str, dict] | None = None  # leaf -> {hash, file}

    def wait(self) -> None:
        self._writer.wait()

    # -- internals --------------------------------------------------------
    @staticmethod
    def _hash(arr: np.ndarray) -> str:
        import hashlib
        h = hashlib.blake2b(digest_size=16)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()

    def _manifests(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            m = self._MANIFEST_RE.match(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        return sorted(out)

    def _load_last(self) -> dict[str, dict] | None:
        ms = self._manifests()
        if not ms:
            return None
        with open(ms[-1][1]) as f:
            return json.load(f)["leaves"]

    # -- API --------------------------------------------------------------
    def save(self, trees: dict, step: int, meta: dict | None = None):
        if _rank() != 0:
            return None
        payload = _flatten(trees)
        # the hash state is settled only once the previous (possibly
        # async) publish has landed
        self._writer.wait()
        if self._last is None:
            self._last = self._load_last() or {}

        delta_file = f"inc_{step}.npz"
        leaves: dict[str, dict] = {}
        delta: dict[str, np.ndarray] = {}
        for key, arr in payload.items():
            digest = self._hash(arr)
            prev = self._last.get(key)
            if prev is not None and prev["hash"] == digest:
                leaves[key] = prev           # unchanged: point at old file
            else:
                leaves[key] = {"hash": digest, "file": delta_file}
                delta[key] = arr
        manifest = {"step": step, "meta": dict(meta or {}, step=step),
                    "leaves": leaves}

        def publish():
            # the hash state advances only after the manifest is published:
            # a failed write drops it, so the next save re-reads the disk
            try:
                if delta:
                    tmp = os.path.join(self.directory, delta_file + ".tmp")
                    with open(tmp, "wb") as f:
                        np.savez(f, **delta)
                    os.replace(tmp,
                               os.path.join(self.directory, delta_file))
                mpath = os.path.join(self.directory,
                                     f"manifest_{step}.json")
                tmp = mpath + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(manifest, f)
                os.replace(tmp, mpath)  # atomic publish marks step complete
            except BaseException:
                self._last = None
                raise
            self._last = leaves
            self._gc()
            return mpath

        if self.async_write:
            self._writer.submit(publish)
            return os.path.join(self.directory, f"manifest_{step}.json")
        return publish()

    def _gc(self) -> None:
        ms = self._manifests()
        drop, kept = ms[:-self.keep], ms[-self.keep:]
        live_files = set()
        for _, mp in kept:
            with open(mp) as f:
                for entry in json.load(f)["leaves"].values():
                    live_files.add(entry["file"])
        for _, mp in drop:
            os.remove(mp)
        for name in os.listdir(self.directory):
            if (name.startswith("inc_") and name.endswith(".npz")
                    and name not in live_files):
                os.remove(os.path.join(self.directory, name))

    def list(self) -> list[tuple[int, str]]:
        self._writer.wait()
        return self._manifests()

    def restore(self, like: dict) -> tuple[dict, dict] | None:
        """The latest VERIFIED manifest in ``like``'s structure: the
        per-leaf content hashes double as integrity checks, a corrupt delta
        file quarantines its manifest, and the restore falls back to the
        previous one."""
        for _, mpath in reversed(self.list()):
            try:
                return self._restore_manifest(mpath, like)
            except CorruptCheckpointError as e:
                _quarantine(mpath, e)
                self._last = None  # cached hash state may cite the bad file
        return None

    def _restore_manifest(self, mpath: str, like: dict):
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError, UnicodeDecodeError) as e:
            raise CorruptCheckpointError(
                f"manifest {mpath} is unreadable: {e}") from e
        by_file: dict[str, list[str]] = {}
        for key, entry in manifest["leaves"].items():
            by_file.setdefault(entry["file"], []).append(key)
        flat: dict[str, np.ndarray] = {}
        for fname, keys in by_file.items():
            fpath = os.path.join(self.directory, fname)
            try:
                with np.load(fpath) as z:
                    for k in keys:
                        flat[k] = z[k]
            except Exception as e:
                raise CorruptCheckpointError(
                    f"delta file {fpath} is unreadable: {e}") from e
        bad = [k for k, entry in manifest["leaves"].items()
               if self._hash(flat[k]) != entry["hash"]]
        if bad:
            raise CorruptCheckpointError(
                f"manifest {mpath}: {len(bad)} leaves failed content-hash "
                f"verification (e.g. {bad[:3]})")
        return _place_like(like, flat), manifest["meta"]
