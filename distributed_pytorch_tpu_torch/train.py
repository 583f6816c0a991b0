"""The VGG trainer on one device: the port of the JAX package's train.py.

The JAX trainer runs one compiled step per dispatch with a pluggable
gradient-sync strategy; this slice ports its single-process path (strategy
``"none"``, the reference's main.py).  A step is the JAX step with no mesh:

- the uint8 NHWC batch crosses to the device, is augmented there
  (data/augment.py: random crop from the 4-pixel zero-padded canvas,
  horizontal flip, normalize) or only normalized (``augment=False``);
- VGG forward in ``compute_dtype`` over float32 params (models/vgg.py),
  float32 cross-entropy, autograd backward, the per-step health flag (loss
  and gradient sum of squares finite) and the [grad-norm, param-norm]
  scalars of ``ops.nn.step_metrics``;
- ``torch.optim.SGD(lr, momentum, weight_decay)``: the update of optax's
  ``add_decayed_weights(wd)`` then ``sgd(lr, momentum)`` (grad += wd * p,
  then the momentum buffer, then the step), in place.

The augmentation draws come from a generator seeded by ``(seed, step)``
alone, so ``steps_per_loop=K`` gives the trajectory of K single steps.  The
draws are torch's, not the JAX package's bits: equal trajectories across
the packages hold with ``augment=False`` (or given the same draws).

``TrainConfig`` keeps every field of the JAX config with its default;
anything but strategy ``"none"`` and the sync knobs' off values belongs to
the data-parallel slice and raises ``NotImplementedError`` naming it.  The
default ``strategy="ddp"`` therefore raises until then; the command line
passes ``--strategy none``, the reference's main.py.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .data import augment as aug
from .data import pipeline
from .models import vgg
from .models.transformer import SYSTEMS_SLICE, not_ported
from .ops import nn as ops
from .utils.device import resolve_device
from .utils.metrics import IterTimeMeter, LossMeter

# The JAX package's strategy names (parallel/strategies.available()) and
# its two resolvers.
STRATEGIES = ("all_reduce", "bucketed", "ddp", "gather_scatter",
              "gather_scatter_symmetric", "hierarchical", "none",
              "quantized", "quantized_ring", "quantized_ring_ef", "auto",
              "routed")


@dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig``, field for field; defaults are the
    reference's settings (see the JAX docstrings for each knob)."""

    model: str = "VGG11"
    lr: float = 0.1               # main.py:103
    momentum: float = 0.9         # main.py:104
    weight_decay: float = 1e-4    # main.py:104
    batch_size: int = 256         # per replica (main.py:18)
    strategy: str = "ddp"
    overlap: bool = False
    overlap_bucket_mb: float | None = None
    dcn_size: int = 2
    dcn_compress: str | None = None
    sync_route: str | None = None
    autotune_profile: Any = None
    steps_per_loop: int = 1       # K optimizer steps per train_steps call
    sync_bn: bool = False         # reference never syncs BN
    broadcast_buffers: bool | None = None
    compute_dtype: str | None = None  # e.g. "bfloat16"
    augment: bool = True
    seed: int = 1                 # torch.manual_seed(1), main.py:70
    sync_every: int = 1
    max_sync_every: int = 1
    outer_opt: str | None = None
    outer_momentum: float = 0.9
    outer_lr: float = 1.0

    @property
    def dtype(self) -> torch.dtype | None:
        """compute_dtype as a torch dtype (None = float32)."""
        return getattr(torch, self.compute_dtype) if self.compute_dtype \
            else None

    @property
    def broadcast_buffers_resolved(self) -> bool:
        if self.broadcast_buffers is not None:
            return self.broadcast_buffers
        return self.strategy in ("ddp", "bucketed")


# Fields whose other values belong to the data-parallel slice: name -> the
# value that leaves them off.
_LATER = {"overlap": False, "overlap_bucket_mb": None, "dcn_size": 2,
          "dcn_compress": None, "sync_route": None, "autotune_profile": None,
          "sync_bn": False, "sync_every": 1, "max_sync_every": 1,
          "outer_opt": None}


def validate_train_cfg(cfg: TrainConfig) -> None:
    """ValueError for what the JAX package refuses too; NotImplementedError,
    naming the slice, for any strategy but "none" and any sync knob."""
    if cfg.model not in vgg.CFG:
        raise ValueError(f"unknown model {cfg.model!r}; expected one of "
                         f"{sorted(vgg.CFG)}")
    if cfg.strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {cfg.strategy!r}; expected one "
                         f"of {list(STRATEGIES)}")
    if cfg.strategy != "none":
        raise not_ported(f"TrainConfig.strategy={cfg.strategy!r} (data "
                         f"parallel; pass strategy='none')", SYSTEMS_SLICE)
    for name, off in _LATER.items():
        value = getattr(cfg, name)
        if value != off:
            raise not_ported(f"TrainConfig.{name}={value!r}", SYSTEMS_SLICE)
    if cfg.broadcast_buffers_resolved:
        raise not_ported("TrainConfig.broadcast_buffers=True", SYSTEMS_SLICE)


def _single_device(strategy, mesh) -> None:
    if strategy not in (None, "none") or mesh is not None:
        raise not_ported(f"a gradient-sync strategy ({strategy!r}) or a "
                         f"mesh", SYSTEMS_SLICE)


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.SGD:
    """``torch.optim.SGD(lr, momentum, weight_decay)`` over ``params`` (a
    nested VGG dict or an iterable of tensors): grad + wd * p, then
    buf = momentum * buf + grad (buf = grad on the first step), then
    p -= lr * buf — optax's ``chain(add_decayed_weights(wd),
    sgd(lr, momentum))``."""
    if isinstance(params, dict):
        params = vgg.flatten(params).values()
    return torch.optim.SGD(list(params), lr=cfg.lr, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay)


def augment_seed(seed: int, step: int) -> int:
    """The augmentation generator's seed for optimizer step ``step``: a
    function of (seed, step) only."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def _loss_fn(params, state, gen, images, labels, *, cfg: TrainConfig,
             fused_bn: bool | None = None):
    """Forward + loss on one batch; images are raw uint8 NHWC."""
    if cfg.augment:
        x = aug.augment(gen, images)
    else:
        x = aug.normalize(images)
    logits, new_state = vgg.apply(params, state, x, name=cfg.model,
                                  train=True, dtype=cfg.dtype,
                                  fused_bn=fused_bn)
    return ops.cross_entropy_loss(logits, labels), new_state


def make_train_step(cfg: TrainConfig, strategy=None, mesh=None, *,
                    fused_bn: bool | None = None):
    """``step(params, state, opt, step, images, labels) -> (loss,
    new_state, ok, met)``: one optimizer step, updating the float32 leaves
    of ``params`` (which require grad) through ``opt`` in place.

    ``images`` (B, 32, 32, 3) uint8 and ``labels`` (B,) on the params'
    device; ``step`` seeds the augmentation.  ``ok`` is 1.0 when the loss
    and the gradient sum of squares are finite; ``met`` is [grad-norm,
    param-norm after the update].  ``fused_bn`` is the model's own switch
    (``vgg.apply``), None (the plain path) as in the JAX trainer."""
    validate_train_cfg(cfg)
    _single_device(strategy, mesh)
    gens: dict[torch.device, torch.Generator] = {}

    def step(params, state, opt, step_idx, images, labels):
        gen = gens.get(images.device)
        if gen is None:
            gen = gens[images.device] = torch.Generator(device=images.device)
        gen.manual_seed(augment_seed(cfg.seed, step_idx))
        leaves = list(vgg.flatten(params).values())
        opt.zero_grad(set_to_none=True)
        loss, new_state = _loss_fn(params, state, gen, images, labels,
                                   cfg=cfg, fused_bn=fused_bn)
        loss.backward()
        gsq = torch.stack(torch._foreach_norm(
            [p.grad for p in leaves])).square().sum()
        ok = (torch.isfinite(loss) & torch.isfinite(gsq)).float()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach(), new_state, ok, ops.step_metrics(gsq, leaves)

    return step


def make_multi_step(cfg: TrainConfig, strategy=None, mesh=None):
    """``fn(params, state, opt, step0, images, labels) -> (state, losses,
    oks, mets)`` over K stacked batches (K, B, ...): K optimizer steps, the
    i-th seeded by ``step0 + i``, so the trajectory equals K single
    steps."""
    step = make_train_step(cfg, strategy, mesh)

    def multi_step(params, state, opt, step0, images, labels):
        losses, oks, mets = [], [], []
        for i in range(images.shape[0]):
            loss, state, ok, met = step(params, state, opt, step0 + i,
                                        images[i], labels[i])
            losses.append(loss)
            oks.append(ok)
            mets.append(met)
        return (state, torch.stack(losses), torch.stack(oks),
                torch.stack(mets))

    return multi_step


def _trainable(params: dict, dev: torch.device) -> dict:
    return {k: {n: t.detach().to(dev, torch.float32).clone()
                .requires_grad_(True) for n, t in v.items()}
            for k, v in params.items()}


def _buffers(state: dict, dev: torch.device) -> dict:
    return {k: {n: t.detach().to(dev, torch.float32).clone()
                for n, t in v.items()} for k, v in state.items()}


class Trainer:
    """Owns float32 ``params``, the BN running ``state`` and the SGD
    optimizer on one device, and drives epochs with the reference's metric
    windows (reference main.py:84-135).

    ``device`` defaults to ``"cuda"`` and raises without a GPU unless
    ``"cpu"`` is asked for.  Params are drawn by the port's own ``vgg.init``
    from ``cfg.seed`` (not the JAX package's draws); ``load_state`` takes
    params, BN state and momentum carried from a JAX run (convert.py).
    ``mesh`` and ``num_devices`` > 1 belong to the data-parallel slice."""

    def __init__(self, cfg: TrainConfig, mesh=None,
                 num_devices: int | None = None, *,
                 device: str | torch.device = "cuda"):
        validate_train_cfg(cfg)
        if mesh is not None or num_devices not in (None, 1):
            raise not_ported("Trainer over a mesh or several devices",
                             SYSTEMS_SLICE)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.strategy = cfg.strategy
        self.sync_plan = None
        self.mesh = None
        self.n_replicas = 1
        params, state = vgg.init(cfg.seed, cfg.model, device=self.device)
        self.params = _trainable(params, self.device)
        self.state = state
        self.opt = make_optimizer(cfg, self.params)
        self._multi_fn = make_multi_step(cfg)
        self._step = 0
        self.last_ok = None       # (K,) health flags of the last call
        self.last_metrics = None  # (K, 2) [grad-norm, param-norm]

    def load_state(self, params: dict, state: dict | None = None,
                   momentum: dict | None = None) -> None:
        """Take params (the port's nested dict, e.g. from
        ``convert.from_jax_vgg``), optionally the BN running state and the
        momentum buffers (``convert.from_jax_sgd_state``)."""
        if {k: sorted(v) for k, v in params.items()} != \
                {k: sorted(v) for k, v in self.params.items()}:
            raise ValueError("params do not match the model's parameter "
                             "names")
        self.params = _trainable(params, self.device)
        if state is not None:
            self.state = _buffers(state, self.device)
        self.opt = make_optimizer(self.cfg, self.params)
        if momentum is not None:
            bufs = vgg.flatten(_buffers(momentum, self.device))
            for name, p in vgg.flatten(self.params).items():
                self.opt.state[p]["momentum_buffer"] = bufs[name]

    def momentum(self) -> dict:
        """The SGD momentum buffers as a nested dict shaped like the params
        (zeros before the first step)."""
        out: dict = {}
        for k, v in self.params.items():
            out[k] = {}
            for n, p in v.items():
                buf = self.opt.state.get(p, {}).get("momentum_buffer")
                out[k][n] = (torch.zeros_like(p) if buf is None
                             else buf).detach().clone()
        return out

    def _to_device(self, images, labels):
        return (torch.as_tensor(np.asarray(images)).to(self.device),
                torch.as_tensor(np.asarray(labels)).to(self.device))

    def train_step(self, images, labels) -> torch.Tensor:
        """One optimizer step on a (B, 32, 32, 3) uint8 batch; returns the
        loss as a 0-dim tensor (not fetched to the host)."""
        return self.train_steps(np.asarray(images)[None],
                                np.asarray(labels)[None])[0]

    def train_steps(self, images, labels) -> torch.Tensor:
        """``K = images.shape[0]`` steps over stacked batches (K, B, ...),
        numpy or tensors; returns the K losses (a device tensor).  The same
        trajectory as K ``train_step`` calls."""
        if not isinstance(images, torch.Tensor):
            images, labels = self._to_device(images, labels)
        k = images.shape[0]
        self.state, losses, self.last_ok, self.last_metrics = \
            self._multi_fn(self.params, self.state, self.opt, self._step,
                           images, labels.long())
        self._step += k
        return losses

    def train_epoch(self, loaders, epoch: int, *, log=print, on_step=None):
        """One epoch with the reference's metric windows (loss/20 iters,
        time/40 iters excluding iteration 0); returns (LossMeter,
        IterTimeMeter).

        ``loaders``: one DataLoader (or a one-element list).  Batches are
        stacked into ``steps_per_loop`` chunks (a ragged final batch flushes
        early) and copied to the device on a prefetch thread, so the copy
        of the next chunk overlaps the current one's compute.  Each chunk's
        losses are fetched at its end, as the reference's ``loss.item()``
        does every iteration.  ``on_step(step)`` fires before each chunk."""
        if not isinstance(loaders, (list, tuple)):
            loaders = [loaders]
        if len(loaders) != 1:
            raise not_ported(f"{len(loaders)} per-replica loaders",
                             SYSTEMS_SLICE)
        for dl in loaders:
            dl.set_epoch(epoch)
        loss_meter, time_meter = LossMeter(), IterTimeMeter()

        def record(batch_idx, loss_val, elapsed):
            rec = loss_meter.update(batch_idx, loss_val)
            if rec and log:
                log(f"Epoch: {epoch + 1}, Iteration: {rec.first_iter}-"
                    f"{rec.last_iter}, Average Loss: {rec.value:.3f}")
            rec = time_meter.update(batch_idx, elapsed)
            if rec and log:
                log(f"Avg Time for iteration {rec.first_iter}-"
                    f"{rec.last_iter}: {rec.value} seconds.")

        spl = max(1, self.cfg.steps_per_loop)

        def host_chunks():
            chunk: list[tuple[np.ndarray, np.ndarray]] = []
            for images, labels in loaders[0]:
                if chunk and images.shape != chunk[0][0].shape:
                    yield chunk
                    chunk = []
                chunk.append((images, labels))
                if len(chunk) == spl:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk

        def staged():
            for chunk in host_chunks():
                yield (len(chunk),) + self._to_device(
                    np.stack([c[0] for c in chunk]),
                    np.stack([c[1] for c in chunk]))

        batch_idx = 0
        for k, images, labels in pipeline.prefetch(staged(), depth=2):
            if on_step is not None:
                on_step(self._step)
            begin = time.perf_counter()
            losses = self.train_steps(images, labels).cpu().numpy()
            per_step = (time.perf_counter() - begin) / k
            for loss_val in losses:
                record(batch_idx, float(loss_val), per_step)
                batch_idx += 1
        return loss_meter, time_meter

    def eval_state(self) -> dict:
        """A copy of the BN running state, for evaluation."""
        return _buffers(self.state, self.device)

    # -- later slices -----------------------------------------------------
    def rebuild(self, *args, **kwargs):
        raise not_ported("Trainer.rebuild (elastic resize)", SYSTEMS_SLICE)

    def check_consistency(self):
        raise not_ported("Trainer.check_consistency (replica invariants)",
                         SYSTEMS_SLICE)
