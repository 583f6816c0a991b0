"""Fused BatchNorm+ReLU backward: the port of the JAX package's
ops/fused_bn.py.

The whole train-mode BN backward collapses onto two per-channel sums.  With
``xhat = (a - mean) * rstd``, ``y`` the forward's normalized value,
``r = relu(y)`` and ``dy = dr * (y > 0)``:

    da = gamma * rstd * (dy - (s1 + xhat * s2) / n)
    dbeta = s1 = sum(dy);   dgamma = s2 = sum(dy * xhat)

so one pass over (dr, a) gives (s1, s2) and a second writes ``da``: five
activation-sized passes (2 reads, 2 reads, 1 write), where autograd's
backward of the explicit BN arithmetic (ops/nn.py) makes roughly 10-14.
The ReLU mask is recomputed from ``a`` with the forward's own arithmetic
(``nn.normalize``), so no mask is stored and the backward agrees with the
forward on which elements were clipped.  The statistics' through-graph
gradient is baked into ``da``, so the caller passes detached ``mean`` and
``rstd`` (``nn.batchnorm_relu`` does).

- ``bn_relu``: a ``torch.autograd.Function`` whose forward is
  ``nn.normalize`` + ``relu``, the plain path's expression, so fused and
  plain forwards are bitwise equal; its backward is ``bn_relu_bwd``.
- ``bn_relu_bwd``: on CUDA tensors it launches the hand-written kernels of
  csrc/fused_bn.cu, K1a (``bn_relu_bwd_reduce``: the sums) then K1b
  (``bn_relu_bwd_apply``: ``da``), each counting its launches; on CPU
  tensors it runs ``bn_relu_bwd_plain``, the port of the JAX ``_bwd_xla``.
  A CUDA input the kernels do not take raises; there is no fallback.
- ``supported`` (always False: ``fused=None`` resolves to the plain path, as
  in the JAX package) and ``applicable`` (the JAX kernel's envelope).

The JAX package's ``FUSED_BN_BWD`` environment switch is not carried over:
on the card it would route the main path to the plain closed form, which
``chip_smoke.py`` times beside the kernels instead.
"""

from __future__ import annotations

import ctypes

import torch

from . import nn

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _mask_dy_xhat(dr, a, mean, rstd, gamma, beta):
    """The forward-exact ReLU mask applied to dr, as float32 ``dy``, and the
    float32 ``xhat``; (C,) float32 vectors, channels on dim 1."""
    inv_c = (rstd * gamma).to(a.dtype)
    y = nn.normalize(a, mean, inv_c, beta)
    dy = torch.where(y > 0, dr, torch.zeros((), dtype=a.dtype,
                                            device=a.device))
    xhat = (a.float() - nn.channel(mean, a)) * nn.channel(rstd, a)
    return dy.float(), xhat


def _sums_plain(dr, a, mean, rstd, gamma, beta):
    dy, xhat = _mask_dy_xhat(dr, a, mean, rstd, gamma, beta)
    dims = (0, *range(2, a.ndim))
    return dy.sum(dims), (dy * xhat).sum(dims)


def _apply_plain(dr, a, mean, rstd, gamma, beta, s1, s2):
    dy, xhat = _mask_dy_xhat(dr, a, mean, rstd, gamma, beta)
    n = a.numel() // a.shape[1]
    coef = gamma * rstd
    da = nn.channel(coef, a) * (
        dy - (nn.channel(s1, a) + xhat * nn.channel(s2, a)) * (1.0 / n))
    return da.to(a.dtype)


def bn_relu_bwd_plain(dr, a, mean, rstd, gamma, beta):
    """(da, dgamma, dbeta) in plain PyTorch: the JAX ``_bwd_xla``.  ``a``
    and ``dr`` are (N, C, H, W) or (M, C) in the compute dtype; ``mean``,
    ``rstd``, ``gamma``, ``beta`` float32 (C,).  The mask comes from the
    forward's arithmetic in the compute dtype; sums and ``da`` in float32,
    ``da`` cast to the compute dtype."""
    s1, s2 = _sums_plain(dr, a, mean, rstd, gamma, beta)
    return _apply_plain(dr, a, mean, rstd, gamma, beta, s1, s2), s2, s1


# -- the kernels (csrc/fused_bn.cu) ----------------------------------------

def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(name: str, dr, a, *vecs) -> tuple[int, int]:
    """(M, C) of two (M, C) row-major operands on the GPU, or ValueError."""
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    if a.dtype not in _DTYPES or dr.dtype != a.dtype:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16 "
                         f"(dr {dr.dtype}, a {a.dtype})")
    if a.ndim != 2 or dr.shape != a.shape:
        raise ValueError(f"{name}: kernel operands are (M, C), got "
                         f"{tuple(dr.shape)}/{tuple(a.shape)}")
    if not (a.is_contiguous() and dr.is_contiguous()):
        raise ValueError(f"{name}: kernel operands must be contiguous rows")
    m, c = a.shape
    if m < 1 or c < 1 or m * c >= 2 ** 31:
        raise ValueError(f"{name}: the kernel takes 1 <= M, C and "
                         f"M * C < 2^31, got {(m, c)}")
    for v in vecs:
        if (v.device != a.device or v.dtype != torch.float32
                or v.shape != (c,) or not v.is_contiguous()):
            raise ValueError(f"{name}: per-channel vectors are contiguous "
                             f"float32 ({c},) on {a.device}")
    return m, c


def _vec(c: int, itemsize: int, ptrs) -> int:
    """Channels a thread loads at once: 16-byte vectors where C and every
    pointer allow, else 1."""
    vec = 16 // itemsize
    return 1 if c % vec or any(p % 16 for p in ptrs) else vec


_PLAN_FIELDS = ("tile", "tiles", "ty_n", "blocks", "rows", "stride",
                "workspace_floats")
# (library path, M, C, vec, itemsize, SMs) -> the plan
_PLANS: dict = {}


def _plan(lib: ctypes.CDLL, m: int, c: int, vec: int, itemsize: int,
          n_sm: int) -> dict:
    """The launch plan of K1a and K1b over (M, C) rows of ``itemsize``-byte
    values, ``vec`` channels a load, on ``n_sm`` SMs, as csrc/fused_bn.cu
    computes it for each launch (``make_plan``, read through
    ``fused_bn_plan``): channel tiles of ``tile`` vectors (one 128-byte
    line of a row, or all of C), ``tiles`` of them across C, ``ty_n``
    threads down a block; ``blocks`` row blocks of ``rows`` rows a tile,
    one wave over the card; K1a's partial rows of ``stride`` floats and
    its workspace of ``workspace_floats``.  ``lib`` is the kernels'
    library, or that file's plan alone built by the host compiler.
    ValueError for arguments no launch takes."""
    key = (lib._name, m, c, vec, itemsize, n_sm)
    if key not in _PLANS:
        fn = lib["fused_bn_plan"]  # its own prototype, not ops/_build.py's
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int64)]
        out = (ctypes.c_int64 * len(_PLAN_FIELDS))()
        if fn(m, c, vec, itemsize, n_sm, out):
            raise ValueError(f"fused_bn: no launch plan for M={m} C={c} "
                             f"vec={vec} itemsize={itemsize} on {n_sm} SMs")
        _PLANS[key] = dict(zip(_PLAN_FIELDS, out))
    return _PLANS[key]


# device index -> its SM count
_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


# (device, stream) -> K1a's workspace as csrc/fused_bn.cu lays it out:
# arrival counters, which every launch leaves at 0 and which keep their
# place whatever the plan, then partials, which every launch writes before
# it reads them.  Launches on one stream run in turn, so they may share
# one; each stream has its own.  Grown (zeroed), never shrunk; nothing is
# cleared per call.
_WORKSPACE: dict = {}


def _workspace(device, stream: int, n_floats: int) -> torch.Tensor:
    key = (device, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < n_floats:
        ws = _WORKSPACE[key] = torch.zeros(n_floats, dtype=torch.float32,
                                           device=device)
    return ws


def _lib() -> ctypes.CDLL:
    from ._build import load_library
    return load_library("fused_bn")


def _launch(entry: str, a: torch.Tensor, *args) -> None:
    """Call ``entry`` of csrc/fused_bn.cu on a's current stream; raise on the
    CUDA error it returns."""
    lib = _lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream)
    err = getattr(lib, entry)(*args, stream)
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({lib.fused_bn_error(err).decode()})")


def bn_relu_bwd_reduce(dr, a, mean, rstd, gamma, beta):
    """K1a: per-channel ``(s1, s2)`` float32 over (M, C) rows.

    On CUDA tensors this launches the one kernel that sums each row block
    and merges the blocks' partials in the same launch (the last block of
    a channel tile to arrive sums them in a fixed order: no float atomics,
    bitwise repeatable) and adds one to ``bn_relu_bwd_reduce.launches``; on
    CPU tensors it runs the plain sums."""
    if a.device.type == "cpu":
        return _sums_plain(dr, a, mean, rstd, gamma, beta)
    m, c = _check("bn_relu_bwd_reduce", dr, a, mean, rstd, gamma, beta)
    isz = a.element_size()
    vec = _vec(c, isz, (dr.data_ptr(), a.data_ptr()))
    plan = _plan(_lib(), m, c, vec, isz, _sm_count(a.device))
    ws = _workspace(a.device,
                    torch.cuda.current_stream(a.device).cuda_stream,
                    plan["workspace_floats"])
    s1 = torch.empty(c, dtype=torch.float32, device=a.device)
    s2 = torch.empty_like(s1)
    _launch("bn_relu_bwd_reduce_launch", a, _DTYPES[a.dtype], vec, _ptr(dr),
            _ptr(a), _ptr(mean), _ptr(rstd), _ptr(gamma), _ptr(beta),
            _ptr(ws), _ptr(s1), _ptr(s2), m, c, ws.numel())
    bn_relu_bwd_reduce.launches += 1
    return s1, s2


def bn_relu_bwd_apply(dr, a, mean, rstd, gamma, beta, s1, s2):
    """K1b: ``da`` over (M, C) rows in a's dtype.  On CUDA tensors this
    launches the elementwise kernel over the same plan and adds one to
    ``bn_relu_bwd_apply.launches``; on CPU tensors it runs the plain
    version."""
    if a.device.type == "cpu":
        return _apply_plain(dr, a, mean, rstd, gamma, beta, s1, s2)
    m, c = _check("bn_relu_bwd_apply", dr, a, mean, rstd, gamma, beta, s1,
                  s2)
    da = torch.empty_like(a)
    vec = _vec(c, a.element_size(),
               (dr.data_ptr(), a.data_ptr(), da.data_ptr()))
    _launch("bn_relu_bwd_apply_launch", a, _DTYPES[a.dtype], vec, _ptr(dr),
            _ptr(a), _ptr(mean), _ptr(rstd), _ptr(gamma), _ptr(beta),
            _ptr(s1), _ptr(s2), _ptr(da), m, c, ctypes.c_float(1.0 / m))
    bn_relu_bwd_apply.launches += 1
    return da


bn_relu_bwd_reduce.launches = 0
bn_relu_bwd_apply.launches = 0


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) channels_last or (M, C) contiguous -> its (M, C) rows, a
    view.  Any other layout is copied into that one first, and the copy is
    counted in ``bn_relu_bwd.copies``: the kernels never see strides."""
    if t.ndim == 4:
        if not t.is_contiguous(memory_format=torch.channels_last):
            t = t.contiguous(memory_format=torch.channels_last)
            bn_relu_bwd.copies += 1
        return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])
    if t.ndim == 2:
        if not t.is_contiguous():
            t = t.contiguous()
            bn_relu_bwd.copies += 1
        return t
    raise ValueError(f"bn_relu_bwd: takes (N, C, H, W) or (M, C), got "
                     f"{tuple(t.shape)}")


def bn_relu_bwd(dr, a, mean, rstd, gamma, beta):
    """(da, dgamma, dbeta) of ``bn_relu``: K1a then K1b on CUDA tensors, the
    plain version on CPU tensors; any other device or a dtype other than
    float32 / bfloat16 raises.  ``da`` has a's shape (channels_last for
    4-D input)."""
    if a.dtype not in _DTYPES:
        raise ValueError(f"bn_relu_bwd: takes float32 or bfloat16, got "
                         f"{a.dtype}")
    if a.device.type == "cpu":
        return bn_relu_bwd_plain(dr, a, mean, rstd, gamma, beta)
    if a.device.type != "cuda":
        raise ValueError(f"bn_relu_bwd: unsupported device {a.device}")
    vecs = [v.detach().float().contiguous() for v in (mean, rstd, gamma,
                                                     beta)]
    dr2, a2 = _rows(dr.to(a.dtype)), _rows(a)
    s1, s2 = bn_relu_bwd_reduce(dr2, a2, *vecs)
    da2 = bn_relu_bwd_apply(dr2, a2, *vecs, s1, s2)
    if a.ndim == 4:
        n, c, h, w = a.shape
        da = da2.view(n, h, w, c).permute(0, 3, 1, 2)
    else:
        da = da2
    return da, s2, s1


bn_relu_bwd.copies = 0


class _BNReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, scale, bias, mean, rstd):
        ctx.save_for_backward(a, scale, bias, mean, rstd)
        return nn.relu(nn.normalize(a, mean, rstd * scale, bias))

    @staticmethod
    def backward(ctx, dr):
        a, scale, bias, mean, rstd = ctx.saved_tensors
        da, dgamma, dbeta = bn_relu_bwd(dr, a, mean, rstd, scale, bias)
        return da, dgamma.to(scale.dtype), dbeta.to(bias.dtype), None, None


def bn_relu(a, scale, bias, mean, rstd):
    """``relu((a - mean) * rstd * scale + bias)`` with the fused backward.

    ``mean`` / ``rstd`` must be the detached batch statistics of ``a``
    (their gradient chain is baked into ``da``); the forward is
    operation-identical to ``nn.batchnorm`` + ``relu``."""
    return _BNReLU.apply(a, scale, bias, mean, rstd)


def supported(x: torch.Tensor, train: bool, axis_name) -> bool:
    """Auto-gate for ``batchnorm_relu(fused=None)``: always False, as in the
    JAX package, where the hand backward measured slower end to end.  On
    the card the question is open (PERF.md); ``applicable`` reports whether
    the kernels could run, for explicit ``fused=True``."""
    return False


def applicable(x: torch.Tensor, train: bool, axis_name) -> bool:
    """The JAX kernel's envelope, channels on dim 1: train mode, local
    (non-synced) statistics, lane-aligned (or lane-foldable) channels.  The
    CUDA kernels take any (M, C); the envelope is kept so both packages
    accept and refuse the same configurations."""
    c = x.shape[1]
    m = x.numel() // c
    if not (train and axis_name is None and m % 8 == 0):
        return False
    if c % 128 == 0:
        return True
    return 128 % c == 0 and m % (8 * (128 // c)) == 0
