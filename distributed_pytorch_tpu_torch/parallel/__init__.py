"""Data parallelism on ``torch.distributed``: the port of the JAX package's
parallel/ (rendezvous, mesh, gradient-sync strategies)."""

from . import init, mesh, strategies
from .init import init_distributed, init_from_env, process_info, shutdown
from .mesh import DATA_AXIS, make_mesh

__all__ = [
    "init", "mesh", "strategies",
    "init_distributed", "init_from_env", "process_info", "shutdown",
    "DATA_AXIS", "make_mesh",
]
