"""Rank-aware structured logging: the port of the JAX package's
utils/logging.py.

The reference imports ``logging`` but never configures it and reports
everything through ``print`` (reference main.py:10).  One ``setup_logging``
call configures the package's root logger (``distributed_pytorch_tpu_torch``)
with a rank-aware format: INFO and WARNING go to stdout, ERROR and above to
stderr, so a supervisor capturing stderr still sees failures.

The rank is resolved per record by a ``logging.Filter``, never cached: a
worker configured before its process group exists, or respawned into a new
generation, logs its current rank.  ``current_rank`` reads the launcher's
env contract first (``RANK``), then ``torch.distributed.get_rank()`` only
when some other module has already imported ``torch.distributed`` and its
default group is initialised; it never imports torch itself, because the
launcher agent logs through this module and stays torch-free.
"""

from __future__ import annotations

import logging
import os
import sys

ROOT = "distributed_pytorch_tpu_torch"


def current_rank() -> int:
    """This process's rank, resolved at call time: env ``RANK``, else the
    initialised default group's rank when ``torch.distributed`` is already
    loaded, else 0.  The one precedence, shared with
    ``utils.telemetry.enable_from_cli``."""
    env = os.environ.get("RANK")
    if env is not None:
        try:
            return int(env)
        except ValueError:
            pass
    dist = sys.modules.get("torch.distributed")
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank())
        except Exception:
            pass
    return 0


class _SysStream(logging.StreamHandler):
    """A stream handler writing to ``sys.stdout`` or ``sys.stderr`` as they
    are at emit time, not as they were at setup (a test harness or a
    server may swap them)."""

    def __init__(self, which: str):
        self._which = which
        super().__init__()

    @property
    def stream(self):
        return getattr(sys, self._which)

    @stream.setter
    def stream(self, value):
        pass


class RankFilter(logging.Filter):
    """Stamps ``record.rank`` on every record at emit time, so the format
    string's ``%(rank)s`` is always the current rank."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.rank = current_rank()
        return True


def setup_logging(level: str = "INFO") -> None:
    """Configure the package's root logger (idempotent: the level updates
    on every call, the handlers are installed once).  INFO and WARNING go to
    stdout, ERROR and above to stderr."""
    root = logging.getLogger(ROOT)
    root.setLevel(level.upper())
    if root.handlers:  # configured already (the filter keeps rank fresh)
        return
    fmt = logging.Formatter(
        "%(asctime)s rank%(rank)s %(name)s %(levelname)s: %(message)s",
        datefmt="%H:%M:%S")
    out = _SysStream("stdout")
    out.addFilter(RankFilter())
    out.addFilter(lambda record: record.levelno < logging.ERROR)
    out.setFormatter(fmt)
    err = _SysStream("stderr")
    err.setLevel(logging.ERROR)
    err.addFilter(RankFilter())
    err.setFormatter(fmt)
    root.addHandler(out)
    root.addHandler(err)
    root.propagate = False


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{name}")
