"""Neural-network primitives: the port of the JAX package's ops/nn.py.

The VGG layers (reference: ``model.py:11-27`` builds Conv3x3 -> BatchNorm2d
-> ReLU blocks and MaxPool2d(2,2)) as plain functions over explicit
parameter dicts, and the losses of both trainers:

- activations are NCHW in ``channels_last`` memory format and conv kernels
  OIHW in ``channels_last`` (the JAX package's NHWC / HWIO hold the same
  numbers in the same physical order), so every BatchNorm input is
  physically (M, C) with C innermost;
- BatchNorm returns its updated running statistics instead of mutating
  buffers, and its arithmetic is the JAX package's, written out: float32
  moments, ``var = E[x^2] - E[x]^2``, ``rsqrt(var + eps)``, the unbiased
  running variance with momentum 0.1, and in a low-precision compute dtype
  the per-element normalization in that dtype with ``mean`` and ``inv``
  cast first.  ``F.batch_norm`` is never called: its Welford variance and
  its own rounding would drift from the reference and from the fused
  backward's recomputed ReLU mask (ops/fused_bn.py);
- a ``dtype`` argument supports bfloat16 compute with float32 parameters
  (params are cast at use, statistics and losses kept in float32).

Initialisation follows torch's defaults (kaiming-uniform with a=sqrt(5) for
conv/linear weights, uniform(+-1/sqrt(fan_in)) for biases, ones/zeros for
BN), drawn from a ``torch.Generator``: the same shapes and bounds as the JAX
package's, not the same values.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..models.transformer import SYSTEMS_SLICE, not_ported

# Torch BatchNorm2d defaults (reference model.py:24 uses defaults).
BN_MOMENTUM = 0.1
BN_EPS = 1e-5

IGNORE_INDEX = -1  # target id excluded from LM losses (padding)


# ---------------------------------------------------------------------------
# Initialisers (torch-default-compatible)
# ---------------------------------------------------------------------------

def kaiming_uniform(gen: torch.Generator, shape: tuple[int, ...],
                    fan_in: int) -> torch.Tensor:
    """torch.nn.init.kaiming_uniform_(a=sqrt(5)) == uniform(+-sqrt(1/fan_in))."""
    bound = math.sqrt(1.0 / fan_in)
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


def fan_in_uniform(gen: torch.Generator, shape: tuple[int, ...],
                   fan_in: int) -> torch.Tensor:
    """torch's default bias init: uniform(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


# ---------------------------------------------------------------------------
# Conv2d
# ---------------------------------------------------------------------------

def conv2d_init(gen: torch.Generator, in_ch: int, out_ch: int,
                ksize: int = 3) -> dict:
    """Parameters for a 2-D convolution (CPU float32); kernel OIHW in
    channels_last memory format."""
    fan_in = in_ch * ksize * ksize
    kernel = kaiming_uniform(gen, (out_ch, in_ch, ksize, ksize), fan_in)
    return {"kernel": kernel.contiguous(memory_format=torch.channels_last),
            "bias": fan_in_uniform(gen, (out_ch,), fan_in)}


def conv2d(params: dict, x: torch.Tensor, *, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """NCHW conv with an OIHW kernel cast to x's dtype (reference conv:
    model.py:18-23)."""
    return F.conv2d(x, params["kernel"].to(x.dtype),
                    params["bias"].to(x.dtype), stride=stride,
                    padding=padding)


# ---------------------------------------------------------------------------
# BatchNorm2d
# ---------------------------------------------------------------------------

def batchnorm_init(num_features: int) -> tuple[dict, dict]:
    """(trainable params, running state) for BatchNorm2d, torch defaults:
    weight=1, bias=0, running_mean=0, running_var=1 (reference
    model.py:24)."""
    params = {"scale": torch.ones(num_features),
              "bias": torch.zeros(num_features)}
    state = {"mean": torch.zeros(num_features),
             "var": torch.ones(num_features)}
    return params, state


def channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel (C,) vector shaped to broadcast along x's dim 1, the
    channel axis of (N, C, H, W) activations and of (M, C) rows alike."""
    return v.view((-1,) + (1,) * (x.ndim - 2))


def normalize(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """``(x - mean) * inv + bias`` per channel, three eager operations each
    rounded to x's dtype.  float32 vectors; in a low-precision dtype they are
    cast to it first (the JAX package's mixed-precision BatchNorm).  The one
    expression of the plain forward, the fused forward and the fused
    backward's ReLU mask (ops/fused_bn.py), so the three agree bit for bit."""
    if x.dtype != torch.float32:
        mean, inv, bias = mean.to(x.dtype), inv.to(x.dtype), bias.to(x.dtype)
    return (x - channel(mean, x)) * channel(inv, x) + channel(bias, x)


def _train_stats(state: dict, x: torch.Tensor, axis_name: str | None
                 ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Train-mode batch statistics and the running-buffer update, shared by
    ``batchnorm`` and the fused ``batchnorm_relu`` path: float32 moments,
    ``var = E[x^2] - E[x]^2`` (biased, used to normalize); the buffers take
    torch's convention (momentum 0.1, the unbiased variance stored).  The
    new buffers carry no gradient."""
    if axis_name is not None:
        raise not_ported(f"batchnorm axis_name={axis_name!r} (sync-BN)",
                         SYSTEMS_SLICE)
    x32 = x.float()
    dims = (0, *range(2, x.ndim))
    mean = x32.mean(dims)
    mean_sq = x32.square().mean(dims)
    var = mean_sq - mean.square()
    n = x32.numel() // x32.shape[1]
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_state = {
            "mean": (1 - BN_MOMENTUM) * state["mean"] + BN_MOMENTUM * mean,
            "var": (1 - BN_MOMENTUM) * state["var"]
            + BN_MOMENTUM * unbiased}
    return mean, var, new_state


def batchnorm(params: dict, state: dict, x: torch.Tensor, *, train: bool,
              axis_name: str | None = None) -> tuple[torch.Tensor, dict]:
    """BatchNorm over (N, C, H, W) input; returns (y, new_state).

    Statistics in float32 whatever the compute dtype; train mode uses the
    batch's, eval mode the running buffers.  ``axis_name`` (sync-BN's
    cross-replica moments) belongs to a later slice and raises in train
    mode; eval mode reads no batch moments, so it has nothing to sync."""
    if train:
        mean, var, new_state = _train_stats(state, x, axis_name)
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var + BN_EPS) * params["scale"].float()
    return normalize(x, mean, inv, params["bias"].float()), new_state


def batchnorm_relu(params: dict, state: dict, x: torch.Tensor, *,
                   train: bool, axis_name: str | None = None,
                   fused: bool | None = None) -> tuple[torch.Tensor, dict]:
    """``relu(batchnorm(x))`` with an optionally FUSED backward.

    The forward is bit for bit ``relu(batchnorm(...))`` in every mode.
    ``fused=True`` replaces autograd's backward with the closed form of
    ops/fused_bn.py (on the GPU, the hand-written kernels K1a and K1b).
    ``fused=None`` resolves to the plain path, as in the JAX package;
    eval mode has no backward to fuse and always takes the plain path."""
    from . import fused_bn

    use = fused_bn.supported(x, train, axis_name) if fused is None \
        else fused
    if not train:
        use = False  # eval has no backward to fuse: plain path, no error
    elif use and not fused_bn.applicable(x, train, axis_name):
        raise ValueError(
            f"fused BN+ReLU does not cover this configuration "
            f"(shape {tuple(x.shape)}, train={train}, axis_name="
            f"{axis_name}): it requires train mode, local (non-synced) "
            f"statistics, and lane-alignable channels — use "
            f"fused=False/None")
    if not use:
        y, new_state = batchnorm(params, state, x, train=train,
                                 axis_name=axis_name)
        return relu(y), new_state
    mean, var, new_state = _train_stats(state, x, axis_name)
    rstd = torch.rsqrt(var + BN_EPS)
    # the fused backward bakes the through-statistics gradient into da:
    # detached statistics keep autograd from counting it a second time
    r = fused_bn.bn_relu(x, params["scale"], params["bias"], mean.detach(),
                         rstd.detach())
    return r, new_state


# ---------------------------------------------------------------------------
# Pooling / Dense
# ---------------------------------------------------------------------------

def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2
             ) -> torch.Tensor:
    """MaxPool2d(kernel_size=2, stride=2) over NCHW (reference model.py:16)."""
    return F.max_pool2d(x, window, stride)


def dense_init(gen: torch.Generator, in_features: int,
               out_features: int) -> dict:
    """Linear layer parameters (CPU float32); kernel (in, out) as in the JAX
    package."""
    return {"kernel": kaiming_uniform(gen, (in_features, out_features),
                                      in_features),
            "bias": fan_in_uniform(gen, (out_features,), in_features)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Linear layer (reference fc1: model.py:40)."""
    return x @ params["kernel"].to(x.dtype) + params["bias"].to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy_per_sample(logits: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy in float32, shared by the training loss and
    the masked eval sum."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return logz - true_logit


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch == torch.nn.CrossEntropyLoss()."""
    return cross_entropy_per_sample(logits, labels).mean()


def accuracy_count(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Number of correct argmax predictions (reference main.py:60-62)."""
    return (logits.argmax(-1) == labels).sum()


def masked_ce(logits: torch.Tensor,
              targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of next-token CE over non-ignored tokens, count), float32 sum
    and an integer count; the caller divides."""
    logits = logits.float()
    mask = targets != IGNORE_INDEX
    safe = torch.where(mask, targets, torch.zeros_like(targets)).long()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = torch.where(mask, logz - true_logit, torch.zeros_like(logz))
    return ce.sum(), mask.sum()


def step_metrics(grad_sq_sum: torch.Tensor, params) -> torch.Tensor:
    """(2,) float32 [grad global-norm, param global-norm]: the per-step
    telemetry scalars, from the gradient sum of squares the health flag
    already needs plus one reduction over the (updated) params."""
    with torch.no_grad():
        psq = torch.stack(torch._foreach_norm(list(params))).float() \
            .square().sum()
        return torch.stack([grad_sq_sum.float().sqrt(), psq.sqrt()])
