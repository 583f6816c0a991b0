"""VGG model family for CIFAR (3x32x32 input, 10 classes): the port of the
JAX package's models/vgg.py.

The reference's ``model.py`` (reference: model.py:3-50) cfg-list idea —
integers are Conv3x3(+bias) -> BatchNorm2d -> ReLU blocks, ``'M'`` is
MaxPool2d(2,2) — as plain functions over nested parameter dicts with the
JAX package's names (``params["conv0"]["kernel"]``, ``state["bn0"]["mean"]``):

- conv kernels are OIHW and activations NCHW, both in ``channels_last``
  memory format (the JAX package's HWIO / NHWC numbers in the same physical
  order; convert.py transposes between them), so every BatchNorm sees
  (M, C) rows with C innermost;
- BatchNorm running statistics live in a separate ``state`` dict returned
  from ``apply``;
- ``init`` draws from a ``torch.Generator``: the JAX package's shapes, tensor
  count and bounds, not its values.

Parity facts kept from the reference: VGG11 has exactly 34 trainable
parameter tensors (8x conv w+b, 8x BN scale+bias, fc w+b) and ~9.23M
parameters.
"""

from __future__ import annotations

import torch

from ..ops import nn as ops
from ..utils.device import resolve_device
from .transformer import SYNC_SLICE, not_ported

# Reference model.py:3-8, verbatim cfg lists; TINY is the JAX package's
# smoke config (same 5-pool topology, ~64x fewer params).
CFG = {
    "VGG11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"],
    "VGG19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
    "TINY": [8, "M", 16, "M", 16, 16, "M", 32, 32, "M", 32, 32, "M"],
}

NUM_CLASSES = 10


def _flatten_features(cfg: list) -> int:
    """Classifier input width: the last conv's channel count (five 2x2 pools
    collapse a 32x32 input to 1x1)."""
    return [c for c in cfg if c != "M"][-1]


def sync_group_index(name: str = "VGG11") -> dict[str, int]:
    """Top-level param key -> forward layer-group index: conv+BN pairs in
    forward order (group i = conv{i}/bn{i}), then the fc head."""
    n_conv = sum(1 for c in CFG[name] if c != "M")
    idx = {"fc": n_conv}
    for i in range(n_conv):
        idx[f"conv{i}"] = i
        idx[f"bn{i}"] = i
    return idx


def _generator(seed) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def to_device(tree: dict, dev: torch.device) -> dict:
    """A nested params / state dict with every tensor detached on ``dev``."""
    return {k: {n: t.detach().to(dev) for n, t in v.items()}
            for k, v in tree.items()}


def init(seed: int | torch.Generator = 0, name: str = "VGG11", *,
         device: str | torch.device = "cuda") -> tuple[dict, dict]:
    """(params, state) for a VGG variant, float32 on ``device``.

    Drawn on the CPU from ``seed`` (an int or a CPU ``torch.Generator``) in
    the JAX package's order — per conv layer kernel then bias, then the fc
    head — so the values do not depend on the device."""
    dev = resolve_device(device)
    gen = _generator(seed)
    params: dict = {}
    state: dict = {}
    in_ch = 3
    idx = 0
    for layer_cfg in CFG[name]:
        if layer_cfg == "M":
            continue
        params[f"conv{idx}"] = ops.conv2d_init(gen, in_ch, layer_cfg, ksize=3)
        params[f"bn{idx}"], state[f"bn{idx}"] = ops.batchnorm_init(layer_cfg)
        in_ch = layer_cfg
        idx += 1
    params["fc"] = ops.dense_init(gen, _flatten_features(CFG[name]),
                                  NUM_CLASSES)
    return to_device(params, dev), to_device(state, dev)


def apply(params: dict, state: dict, x: torch.Tensor, *,
          name: str = "VGG11", train: bool = False,
          dtype: torch.dtype | None = None, bn_axis_name=None,
          fused_bn: bool | None = None,
          boundary=None) -> tuple[torch.Tensor, dict]:
    """Forward pass; returns (float32 logits (B, 10), new_state).

    ``x`` is float NCHW (channels_last, as data/augment.py gives it);
    ``dtype`` the compute dtype (e.g. torch.bfloat16 with float32 params).
    ``fused_bn`` controls the fused BN+ReLU backward (ops/fused_bn.py):
    None resolves to the plain path, True runs the hand-written kernels on
    the GPU; the forward is bitwise the same either way.  ``bn_axis_name``
    (sync-BN) is the process group the train-mode BN moments span (None:
    this rank's batch alone); the fused backward takes local statistics
    only and refuses it, as in the JAX package.  ``boundary`` (overlapped
    gradient sync) belongs to slice 5b and raises."""
    if boundary is not None:
        raise not_ported("vgg.apply boundary (overlapped gradient sync)",
                         SYNC_SLICE)
    if dtype is not None:
        x = x.to(dtype)
    new_state: dict = {}
    idx = 0
    for layer_cfg in CFG[name]:
        if layer_cfg == "M":
            x = ops.max_pool(x)
        else:
            x = ops.conv2d(params[f"conv{idx}"], x)
            x, new_state[f"bn{idx}"] = ops.batchnorm_relu(
                params[f"bn{idx}"], state[f"bn{idx}"], x, train=train,
                axis_name=bn_axis_name, fused=fused_bn)
            idx += 1
    x = x.reshape(x.shape[0], -1)  # (B, 512): spatial 1x1, NHWC order
    logits = ops.dense(params["fc"], x)
    return logits.float(), new_state


def fold_bn(params: dict, state: dict, *, name: str = "VGG11") -> dict:
    """Fold BatchNorm running statistics into the conv weights (inference):
    w' = w * g, b' = (b - mean) * g + beta with g = scale * rsqrt(var +
    eps).  The result has only conv{i}/fc entries, for ``apply_folded``."""
    folded: dict = {}
    idx = 0
    for layer_cfg in CFG[name]:
        if layer_cfg == "M":
            continue
        conv, bn = params[f"conv{idx}"], params[f"bn{idx}"]
        st = state[f"bn{idx}"]
        g = bn["scale"] * torch.rsqrt(st["var"] + ops.BN_EPS)
        folded[f"conv{idx}"] = {
            "kernel": (conv["kernel"] * g[:, None, None, None]).contiguous(
                memory_format=torch.channels_last),
            "bias": (conv["bias"] - st["mean"]) * g + bn["bias"],
        }
        idx += 1
    folded["fc"] = params["fc"]
    return folded


def apply_folded(folded: dict, x: torch.Tensor, *, name: str = "VGG11",
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """Inference forward over ``fold_bn`` params (conv -> ReLU, no separate
    BN); returns (B, 10) float32 logits."""
    if dtype is not None:
        x = x.to(dtype)
    idx = 0
    for layer_cfg in CFG[name]:
        if layer_cfg == "M":
            x = ops.max_pool(x)
        else:
            x = ops.relu(ops.conv2d(folded[f"conv{idx}"], x))
            idx += 1
    x = x.reshape(x.shape[0], -1)
    return ops.dense(folded["fc"], x).float()


def flatten(tree: dict) -> dict[str, torch.Tensor]:
    """Nested ``{"conv0": {"kernel": t, ...}, ...}`` -> ``{"conv0.kernel": t,
    ...}`` in insertion order (the optimizer's parameter order)."""
    return {f"{k}.{n}": t for k, v in tree.items() for n, t in v.items()}


def param_count(params: dict) -> int:
    return sum(t.numel() for t in flatten(params).values())


def tensor_count(params: dict) -> int:
    return len(flatten(params))


# Factory functions mirroring the reference's API surface.

def VGG11(seed=0, *, device="cuda") -> tuple[dict, dict]:
    return init(seed, "VGG11", device=device)


def VGG13(seed=0, *, device="cuda") -> tuple[dict, dict]:
    return init(seed, "VGG13", device=device)


def VGG16(seed=0, *, device="cuda") -> tuple[dict, dict]:
    return init(seed, "VGG16", device=device)


def VGG19(seed=0, *, device="cuda") -> tuple[dict, dict]:
    return init(seed, "VGG19", device=device)
