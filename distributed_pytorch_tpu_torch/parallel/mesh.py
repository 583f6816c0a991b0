"""Device mesh construction: the port of ``make_mesh`` of the JAX package's
parallel/mesh.py.

The JAX mesh enumerates chips; here one process drives one device, so the
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group: ``("data",)`` for the flat strategies, or
``("dcn", "ici")`` with ``axis_shape=(dcn_size, world // dcn_size)`` for
``hierarchical``.  With no process group initialised, ``make_mesh`` first
makes a one-rank group on the device's backend (a ``HashStore``, rank 0,
world 1): the counterpart of the JAX trainer's mesh over its one local
device, so a data-parallel strategy on one card still issues its NCCL
collectives.

``resize_mesh`` keeps the JAX package's rule (the leading axis takes the
change, every inner extent stays) over the process group that stands: a
gang changes its size by drain and re-rendezvous (``launch.py
--elastic``), never in a running process.

``data_sharding``, ``replicated`` and ``shard_batch`` have no counterpart:
each rank holds its own shard of the batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .init import backend_for, bind_device

DATA_AXIS = "data"


def ensure_process_group(device: str | torch.device = "cuda"
                         ) -> torch.device:
    """The default process group for ``device``: the one initialised
    already (its backend must be the device's: no quiet Gloo for a CUDA
    run), else a one-rank group on the device's backend.  Returns the
    bound device."""
    dev = bind_device(device)
    want = backend_for(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if want not in have.split(":") and f"{dev.type}:{want}" not in have:
            raise RuntimeError(
                f"the process group runs on backend {have!r}, but device "
                f"{dev} needs {want!r}")
        return dev
    dist.init_process_group(
        want, store=dist.HashStore(), rank=0, world_size=1,
        **({"device_id": dev} if dev.type == "cuda" else {}))
    return dev


def one_process_per_device(num_devices: int | None) -> None:
    """Refuse ``num_devices`` other than this process group's world size:
    one process drives one device, so several devices take a gang of
    processes (a deliberate divergence from the JAX package's one process
    over all its local chips), and a running gang changes its size by
    drain and re-rendezvous."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_devices not in (None, world):
        raise NotImplementedError(
            f"{num_devices} devices in a process group of {world}: the "
            f"port runs one process per device, so launch {num_devices} "
            f"of them with `python -m distributed_pytorch_tpu_torch.launch "
            f"--nproc-per-node {num_devices} -- ...`; an elastic gang "
            f"changes its size by drain and re-rendezvous (`launch.py "
            f"--elastic`), not in a running process")


def make_mesh(num_devices: int | None = None, *,
              axis_names: tuple[str, ...] = (DATA_AXIS,),
              axis_shape: tuple[int, ...] | None = None,
              device: str | torch.device = "cuda") -> DeviceMesh:
    """A mesh over every rank of the default process group (made first, of
    one rank, if there is none), with ``axis_names`` over ``axis_shape``
    (default: all ranks on the first axis).

    ``num_devices`` must be the world size (or None): one process drives
    one device, so a mesh of several devices comes from a gang of processes
    (``launch.py --nproc-per-node N``), not from one."""
    dev = ensure_process_group(device)
    one_process_per_device(num_devices)
    world = dist.get_world_size()
    if axis_shape is None:
        axis_shape = (world,) + (1,) * (len(axis_names) - 1)
    if len(axis_shape) != len(axis_names) or \
            int(torch.tensor(axis_shape).prod()) != world:
        raise ValueError(f"mesh shape {axis_shape} over axes {axis_names} "
                         f"does not cover the {world} ranks")
    return init_device_mesh(dev.type, tuple(axis_shape),
                            mesh_dim_names=tuple(axis_names))


def resize_mesh(mesh: DeviceMesh, num_devices: int) -> DeviceMesh:
    """``mesh`` rebuilt over ``num_devices`` ranks with its axis names and
    every inner axis extent (the leading data / dcn axis takes the
    change); ``num_devices`` must be a multiple of the inner extents, and
    the world size of the process group that stands (the re-rendezvoused
    gang's).  The JAX function's ``devices`` has no counterpart: a rank is
    a process."""
    shape = tuple(mesh.mesh.shape)
    names = tuple(mesh.mesh_dim_names or (DATA_AXIS,))
    inner = 1
    for n in shape[1:]:
        inner *= n
    if num_devices % inner:
        raise ValueError(
            f"cannot resize mesh {dict(zip(names, shape))} "
            f"to {num_devices} devices: inner axes fix a multiple of "
            f"{inner}")
    one_process_per_device(num_devices)
    return make_mesh(num_devices, axis_names=names,
                     axis_shape=(num_devices // inner,) + shape[1:],
                     device=mesh.device_type)


def mesh_group(mesh: DeviceMesh):
    """The process group over every rank of ``mesh``: a 1-D mesh's group,
    the default group for a factored one (``make_mesh`` spans the world)."""
    return mesh.get_group() if mesh.ndim == 1 else None


def axis_size(mesh: DeviceMesh, axis: str | None = None) -> int:
    """Ranks along ``axis`` of ``mesh`` (all of them with ``axis=None``)."""
    if axis is None:
        return mesh.size()
    return mesh.size(mesh.mesh_dim_names.index(axis))
