"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
``build/torch_kernels/`` at the repository root (listed in .gitignore),
named by a hash of the source and the flags, so a changed source rebuilds
and an unchanged one loads at once.  Nothing builds when a module is
imported: the first call of a kernel's wrapper on a CUDA tensor builds it,
timed as a ``kernel_build`` span on the telemetry stream's compile lane when
telemetry is on (utils/monitor.py ``compile_span``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils import monitor

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signatures of each library's C entry points
_SIGNATURES = {
    "decode_attention": {
        "decode_attention_launch": (
            ctypes.c_int,
            [ctypes.c_int, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 9  # q, k, v, ks, vs, pos, out, ws, counters
            + [ctypes.c_int] * 5  # B, H, Hkv, S, split_len
            + [ctypes.c_float, ctypes.c_void_p]),
        "decode_attention_paged_launch": (
            ctypes.c_int,
            [ctypes.c_int, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 10  # q, k, v, ks, vs, pos, table, out, ws,
            #                           counters
            + [ctypes.c_int] * 6  # B, H, Hkv, page, n_pages, split_len
            + [ctypes.c_float, ctypes.c_void_p]),
        "decode_attention_smem": (ctypes.c_int, [ctypes.c_int] * 3),
        "decode_attention_error": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "flash_attention": {
        "flash_fwd_launch": (
            ctypes.c_int,
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 5  # q, k, v, o, lse
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]),
        "flash_bwd_dq_launch": (
            ctypes.c_int,
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 7  # q, k, v, do, lse, delta, dq
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]),
        "flash_bwd_dkv_launch": (
            ctypes.c_int,
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 8  # q, k, v, do, lse, delta, dk, dv
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]),
        "flash_sm90_smem": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
        "flash_attention_error": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "fused_bn": {
        "bn_relu_bwd_reduce_launch": (
            ctypes.c_int,
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 9  # dr, a, mean, rstd, gamma, beta,
            #                          partial, s1, s2
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
        "bn_relu_bwd_apply_launch": (
            ctypes.c_int,
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 9  # dr, a, mean, rstd, gamma, beta, s1,
            #                          s2, da
            + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]),
        "fused_bn_error": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "int8_matmul": {
        "int8_matmul_launch": (
            ctypes.c_int,
            [ctypes.c_void_p] * 5  # qx, qwt, sx, sw, out
            + [ctypes.c_int] * 5  # M, N, K, out_dtype, route
            + [ctypes.POINTER(ctypes.c_int),  # route_taken
               ctypes.c_void_p]),  # stream
        "int8_matmul_sm90_smem": (ctypes.c_int, []),
        "int8_matmul_error": (ctypes.c_char_p, [ctypes.c_int]),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when the library was already built;
#          each nvcc's own wall time when several build at once),
#          "log": nvcc's output (register / shared-memory report), kept
#          beside the library as <library>.log}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on "
                           "PATH or set CUDA_HOME")
    return str(path)


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers under
    csrc/ (any source may include them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names) -> None:
    """Compile every ``csrc/<name>.cu`` whose hashed library is missing, one
    ``nvcc`` process per source, all started together."""
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            build_info.setdefault(name, {
                "seconds": 0.0,
                "log": log.read_text() if log.exists() else ""})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed building {name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        with monitor.compile_span("kernel_build", key=library_path(name).name,
                                  library=name):
            build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib
