"""Quantized dense compute: the port of the JAX package's ops/quantized.py.

The transformer's dense projections take ``matmul_dtype="int8"``: each
product ``x @ w`` quantizes both operands symmetrically to int8 (per-row
scales for the activation, per-column scales for the weight), takes the
exact integer product, and dequantizes with the rank-1 outer product of the
scales.

- ``quantize_rowwise`` / ``quantize_colwise``: the JAX functions' arithmetic
  in the same order (float32, ``amax / 127``, floor at 1e-30, round half to
  even, clamp to [-127, 127], int8), so the quantized values are bitwise
  the JAX package's.
- ``int8_matmul_plain``: the JAX ``int8_matmul_xla`` in plain PyTorch, the
  oracle of the kernel, optionally cast to bfloat16 as the JAX
  ``quantized_matmul`` casts it.  ``torch.matmul`` has no int32 product on
  CUDA, so the int8 values multiply as float64: every partial sum is an
  integer below 127^2 k < 2^53, so the product is exact and casts to int32
  exactly.
- ``int8_matmul``: the same quantization, then on CUDA tensors the
  hand-written int8 tensor-core kernel of csrc/int8_matmul.cu (K5, the port
  of the TPU kernel ``_matmul_kernel``), on CPU tensors
  ``int8_matmul_plain``.  K5 writes float32, or with ``out_dtype=
  torch.bfloat16`` that float32 rounded to bf16 in its epilogue (the cast
  the bf16 forward needs, with no pass of its own).  Its launch plan
  picks one of two routes from the shape and alignment alone: ``sm90``
  (wgmma fed by a TMA ring, persistent and warp-specialized, its output
  stored by TMA; where TMA can read the operands and write the output:
  k % 16 == 0, output rows of whole 16-byte units, 16-byte-aligned
  pointers, every shape the transformer runs) or ``mma_sync`` (any other
  m, n and k up to ``MAX_K``).  So no shape routes to the plain version,
  and either route's output is bitwise the plain version's.
  ``int8_matmul_q.launches`` counts every launch and
  ``int8_matmul_q.route_launches`` each route's.
- ``quantized_matmul``: int8 forward in x's dtype, straight-through
  backward (``dx = g @ w.T``, ``dw = x.T @ g`` in the cotangent's dtype),
  as the JAX custom VJP.

Shapes are plain (m, k) @ (k, n); the transformer reshapes its 3-D weights
around the call.
"""

from __future__ import annotations

import ctypes

import torch

# |acc| <= 127^2 k must fit an int32: k <= 2^31 / 127^2 = 133,144
MAX_K = 133_000


def _quantize_rows(x: torch.Tensor, dim: int):
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(dim=dim, keepdim=True) / 127.0,
                            1e-30)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_rowwise(x: torch.Tensor):
    """Symmetric int8 per-row quantization of a (m, k) activation:
    ``q * scale ~= x`` with ``scale`` (m, 1) float32."""
    return _quantize_rows(x, 1)


def quantize_colwise(w: torch.Tensor):
    """Symmetric int8 per-column quantization of a (k, n) weight:
    ``q * scale ~= w`` with ``scale`` (1, n) float32."""
    return _quantize_rows(w, 0)


def _dequant(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor):
    # the JAX association, acc * (sx * sw): the kernel's epilogue too
    return acc.float() * (sx * sw)


def _int_product(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 (m, k) and (k, n)."""
    return (qx.double() @ qw.double()).to(torch.int32)


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Quantize both operands, exact integer product, dequantize: (m, k) @
    (k, n) -> float32 (m, n), the JAX ``int8_matmul_xla``, cast to
    ``out_dtype``."""
    qx, sx = quantize_rowwise(x)
    qw, sw = quantize_colwise(w)
    return _dequant(_int_product(qx, qw), sx, sw).to(out_dtype)


# -- the kernel (csrc/int8_matmul.cu) --------------------------------------

def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# K5's output types and routes, as csrc/int8_matmul.cu numbers them
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("mma_sync", "sm90")


def int8_matmul_q(qx, qwt, sx, sw, out_dtype: torch.dtype = torch.float32,
                  route: str | None = None) -> torch.Tensor:
    """K5 on quantized operands: ``qx`` int8 (m, k), ``qwt`` int8 (n, k)
    (the weight's columns as rows: k runs contiguously for the tensor
    cores), ``sx`` float32 (m,) or (m, 1), ``sw`` float32 (n,) or (1, n), all
    contiguous on one CUDA device.  Returns ``acc * (sx * sw)`` (m, n) as
    ``out_dtype`` (float32, or bfloat16 rounded from that float32).  The
    kernel's plan picks the route; ``route`` ("sm90" or "mma_sync") asks
    for one, as the tests and timings do, and "sm90" is refused where TMA
    cannot read the operands or write the output.  Adds one to
    ``int8_matmul_q.launches`` and to the route's
    ``int8_matmul_q.route_launches``."""
    if qx.ndim != 2 or qwt.ndim != 2 or qx.shape[1] != qwt.shape[1]:
        raise ValueError(f"int8_matmul_q: operands are (m, k) and (n, k), "
                         f"got {tuple(qx.shape)}/{tuple(qwt.shape)}")
    m, k = qx.shape
    n = qwt.shape[0]
    if not (1 <= m < 2 ** 31 and 1 <= n < 2 ** 31 and 1 <= k <= MAX_K):
        raise ValueError(f"int8_matmul_q: the kernel takes 1 <= m, n and "
                         f"1 <= k <= {MAX_K} (the int32 sum bound), got "
                         f"m={m} n={n} k={k}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"int8_matmul_q: out_dtype is one of "
                         f"{list(OUT_DTYPES)}, got {out_dtype}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"int8_matmul_q: route is None or one of {ROUTES}, "
                         f"got {route!r}")
    for name, t, dtype, numel in (("qx", qx, torch.int8, m * k),
                                  ("qwt", qwt, torch.int8, n * k),
                                  ("sx", sx, torch.float32, m),
                                  ("sw", sw, torch.float32, n)):
        if t.dtype != dtype or t.numel() != numel:
            raise ValueError(f"int8_matmul_q: {name} must be {dtype} with "
                             f"{numel} elements, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != qx.device or not t.is_contiguous():
            raise ValueError(f"int8_matmul_q: {name} must be contiguous on "
                             f"{qx.device}")
    if qx.device.type != "cuda":
        raise ValueError(f"int8_matmul_q: unsupported device {qx.device}")
    out = torch.empty((m, n), dtype=out_dtype, device=qx.device)
    from ._build import load_library
    lib = load_library("int8_matmul")
    stream = ctypes.c_void_p(torch.cuda.current_stream(qx.device).cuda_stream)
    taken = ctypes.c_int(-1)
    err = lib.int8_matmul_launch(
        _ptr(qx), _ptr(qwt), _ptr(sx), _ptr(sw), _ptr(out), m, n, k,
        OUT_DTYPES[out_dtype], -1 if route is None else ROUTES.index(route),
        ctypes.byref(taken), stream)
    if err:
        raise RuntimeError(f"int8_matmul_launch failed: CUDA error {err} "
                           f"({lib.int8_matmul_error(err).decode()})")
    int8_matmul_q.launches += 1
    int8_matmul_q.route_launches[ROUTES[taken.value]] += 1
    return out


int8_matmul_q.launches = 0
int8_matmul_q.route_launches = dict.fromkeys(ROUTES, 0)


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(m, k) @ (k, n) -> (m, n) through int8, as ``out_dtype`` (float32 or
    bfloat16): quantize both operands, then K5 on CUDA tensors (bitwise
    ``int8_matmul_plain(x, w, out_dtype)``), the plain product on CPU
    tensors.  The weight is quantized as its transpose
    (``quantize_rowwise(w.T)``: the same values and scales as
    ``quantize_colwise(w)``), the layout K5 reads."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"int8_matmul: operands are (m, k) and (k, n), got "
                         f"{tuple(x.shape)}/{tuple(w.shape)}")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, out_dtype)
    qx, sx = quantize_rowwise(x)
    qwt, sw = quantize_rowwise(w.t())
    return int8_matmul_q(qx, qwt.contiguous(), sx, sw, out_dtype)


class _QuantizedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.dtype in OUT_DTYPES:  # K5 writes x's dtype itself
            return int8_matmul(x, w, out_dtype=x.dtype)
        return int8_matmul(x, w).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = (g @ w.t().to(g.dtype)).to(x.dtype)
        dw = (x.t().to(g.dtype) @ g).to(w.dtype)
        return dx, dw


def quantized_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 forward / straight-through backward product of (m, k) @ (k, n):
    the forward is ``int8_matmul`` in x's dtype (float32 or bfloat16
    straight from K5's epilogue; another dtype cast from float32); the
    backward differentiates the plain product in the cotangent's dtype,
    with no rounding on the gradient stream (the JAX
    ``quantized_matmul``)."""
    return _QuantizedMatmul.apply(x, w)
