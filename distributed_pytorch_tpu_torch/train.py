"""The VGG trainer: the port of the JAX package's train.py.

The JAX trainer runs one compiled step per dispatch with a pluggable
gradient-sync strategy (parallel/strategies.py), under ``shard_map`` over a
mesh of devices.  Here each rank is a process driving one device, and a
step is the JAX step on this rank's shard of the global batch:

- the uint8 NHWC batch crosses to the device, is augmented there
  (data/augment.py: random crop from the 4-pixel zero-padded canvas,
  horizontal flip, normalize) or only normalized (``augment=False``);
- VGG forward in ``compute_dtype`` over float32 params (models/vgg.py),
  BatchNorm over this rank's batch or, with ``sync_bn``, over every rank's;
  float32 cross-entropy and autograd backward;
- with ``broadcast_buffers`` (the default of ``ddp`` and ``bucketed``, torch
  DDP's), rank 0's updated BN state replaces every rank's;
- the strategy syncs the gradients (leaves in the JAX package's tree order,
  the rings' in its layout: ``jax_order``), carrying a stateful strategy's
  residual (``sync_state``) per rank; with ``overlap`` each bucket syncs
  inside the backward instead, from a sync point at its earliest layer
  group (``parallel.strategies.OverlapSync``), over the same bucket plan
  and leaf order, so the step is bitwise the post-backward one;
- the health flag (loss and synced gradient sum of squares finite), the
  [grad-norm, param-norm] scalars of ``ops.nn.step_metrics``, and
  ``torch.optim.SGD(lr, momentum, weight_decay)``: the update of optax's
  ``add_decayed_weights(wd)`` then ``sgd(lr, momentum)``, in place.

A ``train_steps`` call averages its losses, health flags and scalars over
the ranks in one collective, as the JAX step's ``pmean``s do.

The augmentation draws come from a generator seeded by ``(seed, step,
rank)`` alone, so ``steps_per_loop=K`` gives the trajectory of K single
steps and replicas draw differently.  The draws are torch's, not the JAX
package's bits: equal trajectories across the packages hold with
``augment=False`` (or given the same draws).

**Sync windows** (``sync_every = H > 1``, local SGD): ``train_steps``
runs K/H windows of H local steps (K a multiple of H).  The params hold
the anchor, the last exchanged point, equal on every rank; each local
step runs at ``anchor + delta``, ``delta`` being the sum of this rank's
optimizer updates since the anchor, the update optax's (``-lr`` times the
momentum trace of ``g + wd * p``) from momentum buffers that stay on each
rank across windows.  A local step syncs nothing under a flat strategy
and takes the within-slice mean (``Hierarchical.local_sync``) under
``hierarchical``.  At the boundary the delta goes through the strategy
(``window_exchange`` for ``hierarchical``; the residual for stateful
ones), and the anchor moves by the mean or, with ``outer_opt``, by the
outer optimizer, whose float32 momentum rides ``sync_state`` as a flat
tail after the residual segments, raveled in the JAX layout.  ``sync_every
= 1`` is the per-step path above, untouched.

With telemetry on (utils/telemetry.py), each ``train_steps`` call emits a
``train_steps`` span, each step's loss, grad-norm and param-norm gauges
(fetched in one copy after the dispatch) and, under windows, a
``sync_window`` span and ``window_wire_bytes`` gauge a window; with it off
nothing is fetched.

Around each ``train_steps`` call the host runs the fault hooks
(utils/faults.py: a straggler plan's sleep, the taps' arming, an injected
crash after it); a fired tap poisons one gradient leaf or scales the loss
after the backward and before the sync.  ``opt_state`` exposes the
momentum buffers for checkpoints (utils/checkpoint.py ``Checkpointer``)
and the training sentry.

``TrainConfig`` keeps every field of the JAX config with its default.
``auto``, ``routed``, the sync route and the autotune profile raise
``NotImplementedError`` naming slice 5f.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .data import augment as aug
from .data import pipeline
from .models import vgg
from .models.transformer import (ELASTIC_SLICE, PLANNING_SLICE,
                                 not_ported)
from .ops import nn as ops
from .parallel import strategies as strat
from .parallel.mesh import (DATA_AXIS, axis_size, ensure_process_group,
                            make_mesh, mesh_group, one_process_per_device)
from .utils import debug as dbg
from .utils import faults, monitor, telemetry, tracing
from .utils.device import resolve_device
from .utils.metrics import IterTimeMeter, LossMeter

# The JAX package's strategy names (parallel/strategies.available()) and
# its two resolvers.
STRATEGIES = tuple(strat.available()) + ("auto", "routed")


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


# Fields whose other values belong to a later slice: name -> (the value
# that leaves them off, the slice).
_LATER = {"sync_route": (None, PLANNING_SLICE),
          "autotune_profile": (None, PLANNING_SLICE)}


def validate_train_cfg(cfg: TrainConfig) -> None:
    """ValueError for what the JAX package refuses too; NotImplementedError,
    naming its sub-slice, for ``auto``, ``routed`` and the knobs of
    ``_LATER``."""
    if cfg.model not in vgg.CFG:
        raise ValueError(f"unknown model {cfg.model!r}; expected one of "
                         f"{sorted(vgg.CFG)}")
    if cfg.strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {cfg.strategy!r}; expected one "
                         f"of {list(STRATEGIES)}")
    if cfg.strategy in ("auto", "routed"):
        raise not_ported(f"TrainConfig.strategy={cfg.strategy!r}",
                         PLANNING_SLICE)
    for name, (off, where) in _LATER.items():
        value = getattr(cfg, name)
        if value != off:
            raise not_ported(f"TrainConfig.{name}={value!r}", where)


def _apply_bucket_mb(cfg: TrainConfig, strategy) -> None:
    """Propagate cfg.overlap_bucket_mb into the strategy's packing knob."""
    if cfg.overlap_bucket_mb is not None and hasattr(strategy,
                                                     "bucket_bytes"):
        strategy.bucket_bytes = int(cfg.overlap_bucket_mb * 1024 * 1024)


def _apply_dcn(cfg: TrainConfig, strategy) -> None:
    """Propagate cfg.dcn_compress / cfg.dcn_size into the strategy (the
    hierarchical slow-hop knobs), before the step and the sync state are
    built: compression makes it stateful.  A strategy without a dcn hop
    refuses the compress knob."""
    if hasattr(strategy, "set_dcn"):
        strategy.set_dcn(cfg.dcn_compress, cfg.dcn_size)
    elif cfg.dcn_compress is not None:
        raise ValueError(
            f"dcn_compress={cfg.dcn_compress!r} quantizes the cross-slice "
            f"hop of the factored-mesh 'hierarchical' strategy; strategy "
            f"{strategy.name!r} has no DCN hop to compress")


def _validate_overlap(cfg: TrainConfig, strategy, mesh) -> None:
    if not cfg.overlap:
        return
    if mesh is None:
        raise ValueError(
            "overlap=True requires a mesh: the data-axis collectives are "
            "the thing being overlapped with backward compute")
    strat.require_overlap_capable(strategy)


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


def augment_seed(seed: int, step: int, rank: int = 0) -> int:
    """The augmentation generator's seed for optimizer step ``step`` on
    ``rank``: a function of (seed, step, rank) only, rank 0's independent
    of the gang (the counterpart of the JAX ``fold_in(key, step)`` then
    ``fold_in(k, axis_index)``)."""
    base = ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)
    return base ^ ((rank * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)


def jax_order(params: dict) -> list[tuple[str, str]]:
    """(layer, name) of every leaf in the JAX package's tree order:
    ``jax.tree`` flattens a dict by sorted keys (``bn0.bias, bn0.scale,
    bn1.bias, ..., conv0.bias, conv0.kernel, ..., fc.kernel``)."""
    return [(k, n) for k in sorted(params) for n in sorted(params[k])]


def _to_jax_layout(t: torch.Tensor) -> torch.Tensor:
    """A conv kernel OIHW as the JAX package's HWIO (a view)."""
    return t.permute(2, 3, 1, 0) if t.ndim == 4 else t


def _from_jax_layout(t: torch.Tensor) -> torch.Tensor:
    return t.permute(3, 2, 0, 1) if t.ndim == 4 else t


def _layout_sensitive(strategy) -> bool:
    """Whether the strategy's numerics depend on the layout of the flat
    vector (block scales span leaf boundaries and group consecutive
    values): the rings, and hierarchical's compressed hop."""
    return strategy.name in ("quantized_ring", "quantized_ring_ef") or \
        getattr(strategy, "dcn_compress", None) is not None


def sync_grads(strategy, mesh, grads: list, sync_state=None, call=None):
    """Run ``strategy`` (or ``call``, a method with its protocol: the
    boundary's ``window_exchange``) over ``grads`` (the
    leaves' gradients in ``jax_order``) and write the result back into
    them; returns the new sync state.  The rings see each conv gradient in
    the JAX layout."""
    jax_layout = _layout_sensitive(strategy)
    given = [_to_jax_layout(g) for g in grads] if jax_layout else grads
    fn = call if call is not None else strategy
    if getattr(strategy, "stateful", False):
        synced, sync_state = fn(given, mesh, sync_state)
    else:
        synced = fn(given, mesh)
    pairs = [(g, _from_jax_layout(s) if jax_layout else s)
             for g, v, s in zip(grads, given, synced) if s is not v]
    if pairs:
        # one multi-tensor copy back, not one operation a leaf
        torch._foreach_copy_([g for g, _ in pairs], [s for _, s in pairs])
    return sync_state


def _broadcast_tree(tree: dict, group) -> dict:
    """Rank 0's values of a nested dict of float32 tensors on every rank of
    ``group`` (one broadcast of the flattened tree); a new dict."""
    leaves = [t for v in tree.values() for t in v.values()]
    flat = torch.cat([t.detach().reshape(-1).float() for t in leaves])
    dist.broadcast(flat, src=0 if group is None
                   else dist.get_global_rank(group, 0), group=group)
    out, offset = {}, 0
    for k, v in tree.items():
        out[k] = {}
        for n, t in v.items():
            out[k][n] = flat[offset:offset + t.numel()].view(t.shape)
            offset += t.numel()
    return out


def _loss_fn(params, state, gen, images, labels, *, cfg: TrainConfig,
             fused_bn: bool | None = None, bn_axis=None, boundary=None):
    """Forward + loss on one batch; images are raw uint8 NHWC.
    ``bn_axis`` is sync-BN's process group (None: local BN); ``boundary``
    the overlap sync hook (``vgg.apply``)."""
    if cfg.augment:
        x = aug.augment(gen, images)
    else:
        x = aug.normalize(images)
    logits, new_state = vgg.apply(params, state, x, name=cfg.model,
                                  train=True, dtype=cfg.dtype,
                                  bn_axis_name=bn_axis, fused_bn=fused_bn,
                                  boundary=boundary)
    return ops.cross_entropy_loss(logits, labels), new_state


def _resolve_strategy(cfg: TrainConfig, strategy, mesh):
    validate_train_cfg(cfg)
    if strategy is None:
        strategy = strat.get(cfg.strategy)
    _apply_dcn(cfg, strategy)
    _apply_bucket_mb(cfg, strategy)
    _validate_overlap(cfg, strategy, mesh)
    if cfg.sync_every > 1 or cfg.outer_opt is not None:
        strat.require_sync_window(
            sync_every=cfg.sync_every, max_sync_every=cfg.max_sync_every,
            mesh=mesh is not None, overlap=cfg.overlap, trainer="train",
            outer_opt=cfg.outer_opt, outer_momentum=cfg.outer_momentum,
            outer_lr=cfg.outer_lr)
    if mesh is None and strategy.needs_mesh:
        raise ValueError(f"strategy {strategy.name!r} requires a mesh")
    return strategy


def make_train_step(cfg: TrainConfig, strategy=None, mesh=None, *,
                    fused_bn: bool | None = None):
    """``step(params, state, opt, step, images, labels, sync_state=None)
    -> (loss, new_state, ok, met, sync_state)``: one optimizer step on this
    rank, updating the float32 leaves of ``params`` (which require grad)
    through ``opt`` in place.

    ``strategy`` defaults to ``cfg.strategy``'s; any but ``none`` syncs over
    ``mesh`` (``parallel.mesh.make_mesh``).  ``images`` (B, 32, 32, 3)
    uint8 and ``labels`` (B,) are this rank's shard, on the params' device;
    ``step`` seeds the augmentation.  ``ok`` is 1.0 when the loss and the
    synced gradient sum of squares are finite; ``met`` is [grad-norm,
    param-norm after the update]; ``loss``, ``ok`` and ``met`` are this
    rank's.  ``sync_state`` is a stateful strategy's residual on this rank
    (``Trainer.sync_state``).  ``fused_bn`` is the model's own switch
    (``vgg.apply``), None (the plain path) as in the JAX trainer.
    ``fault_arm`` feeds the fault taps (utils/faults.py): at the plan's
    step one gradient leaf is poisoned, or the loss scaled, after the
    backward and before the sync (under ``overlap``, before that leaf's
    bucket is launched)."""
    strategy = _resolve_strategy(cfg, strategy, mesh)
    group = mesh_group(mesh) if mesh is not None else None
    rank = dist.get_rank() if mesh is not None else 0
    bn_axis = None
    if cfg.sync_bn and mesh is not None:
        bn_axis = group if group is not None else dist.group.WORLD
    bcast_buffers = cfg.broadcast_buffers_resolved and mesh is not None
    syncs = strategy.name != "none"
    stateful = getattr(strategy, "stateful", False)
    group_idx = vgg.sync_group_index(cfg.model) if cfg.overlap else None
    layout = (_to_jax_layout, _from_jax_layout) \
        if _layout_sensitive(strategy) else None
    gens: dict[torch.device, torch.Generator] = {}

    def step(params, state, opt, step_idx, images, labels, sync_state=None,
             fault_arm=0.0):
        gen = gens.get(images.device)
        if gen is None:
            gen = gens[images.device] = torch.Generator(device=images.device)
        gen.manual_seed(augment_seed(cfg.seed, step_idx, rank))
        opt.zero_grad(set_to_none=True)
        ov = None
        if cfg.overlap:  # the buckets sync inside the backward
            ov = strat.OverlapSync(
                strategy, mesh, params, group_idx, sync_state=sync_state,
                layout=layout,
                tap=faults.grad_tap(step_idx, fault_arm) if fault_arm
                else None)
        loss, new_state = _loss_fn(params, state, gen, images, labels,
                                   cfg=cfg, fused_bn=fused_bn,
                                   bn_axis=bn_axis,
                                   boundary=ov.boundary if ov else None)
        loss.backward()
        if bcast_buffers:
            # torch DDP's broadcast_buffers: rank 0's *updated* BN state on
            # every rank, as the JAX step's masked psum gives it
            new_state = _broadcast_tree(new_state, group)
        leaves = [params[k][n] for k, n in jax_order(params)]
        grads = [p.grad for p in leaves]
        if fault_arm:  # the fault taps, before the sync
            if ov is None:
                grads = faults.tap_grads(grads, step_idx, fault_arm)
                for p, g in zip(leaves, grads):
                    p.grad = g
            loss = faults.tap_loss(loss, step_idx, fault_arm)
        if ov is not None:
            if stateful:
                sync_state = ov.new_state()
        elif syncs:
            sync_state = sync_grads(strategy, mesh, grads, sync_state)
        gsq = torch.stack(torch._foreach_norm(grads)).square().sum()
        ok = (torch.isfinite(loss) & torch.isfinite(gsq)).float()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return (loss.detach(), new_state, ok,
                ops.step_metrics(gsq, leaves), sync_state)

    return step


def _make_window_run(cfg: TrainConfig, strategy, mesh, fused_bn):
    """The windowed K steps: ``run(params, state, opt, step0, images,
    labels, sync_state) -> (state, losses, oks, mets, sync_state)`` (per
    step lists), K/H windows of H local steps, each window ending on the
    boundary exchange (the JAX windowed scan).  ``params`` hold the anchor
    and are updated in place at each boundary; ``opt`` (a
    ``torch.optim.SGD``) only keeps the momentum buffers, keyed by the
    anchor's leaves."""
    strategy = _resolve_strategy(cfg, strategy, mesh)
    group = mesh_group(mesh) if mesh is not None else None
    rank = dist.get_rank() if mesh is not None else 0
    bn_axis = None
    if cfg.sync_bn and mesh is not None:
        bn_axis = group if group is not None else dist.group.WORLD
    bcast_buffers = cfg.broadcast_buffers_resolved and mesh is not None
    hier = hasattr(strategy, "window_exchange")
    outer = strat.OuterOptimizer.of(cfg)
    h = cfg.sync_every
    lr, mom, wd = cfg.lr, cfg.momentum, cfg.weight_decay
    gens: dict[torch.device, torch.Generator] = {}

    def nested(names, leaves) -> dict:
        out: dict = {}
        for (k, n), t in zip(names, leaves):
            out.setdefault(k, {})[n] = t
        return out

    def local_step(names, anchor, delta, state, opt, step_idx, images,
                   labels, fault_arm):
        gen = gens.get(images.device)
        if gen is None:
            gen = gens[images.device] = torch.Generator(device=images.device)
        gen.manual_seed(augment_seed(cfg.seed, step_idx, rank))
        local = [(a.detach() + d).requires_grad_(True)
                 for a, d in zip(anchor, delta)]
        loss, new_state = _loss_fn(nested(names, local), state, gen, images,
                                   labels, cfg=cfg, fused_bn=fused_bn,
                                   bn_axis=bn_axis)
        grads = list(torch.autograd.grad(loss, local))
        if fault_arm:  # the fault taps, before the local sync
            grads = faults.tap_grads(grads, step_idx, fault_arm)
            loss = faults.tap_loss(loss, step_idx, fault_arm)
        if bcast_buffers:
            new_state = _broadcast_tree(new_state, group)
        with torch.no_grad():
            if hier:  # the within-slice mean; flat strategies sync nothing
                torch._foreach_copy_(grads, strategy.local_sync(grads, mesh))
            gsq = torch.stack(torch._foreach_norm(grads)).square().sum()
            ok = (torch.isfinite(loss) & torch.isfinite(gsq)).float()
            # optax's add_decayed_weights then sgd: g + wd * p, the trace
            # g + momentum * trace, the update -lr * trace
            d_p = torch._foreach_add(grads, local, alpha=wd)
            if mom != 0.0:
                bufs = []
                for a, g in zip(anchor, d_p):
                    st = opt.state[a]
                    buf = st.get("momentum_buffer")
                    if buf is None:
                        buf = st["momentum_buffer"] = g.clone()
                    else:
                        buf.mul_(mom).add_(g)
                    bufs.append(buf)
                d_p = bufs
            torch._foreach_add_(delta, torch._foreach_mul(d_p, -lr))
            met = ops.step_metrics(gsq, [a + d for a, d in
                                         zip(anchor, delta)])
        return loss.detach(), new_state, ok, met

    @torch.no_grad()
    def boundary(anchor, delta, sync_state):
        res = sync_state
        if outer is not None:
            split = sync_state.numel() - outer.state_len(anchor)
            res, m_flat = sync_state[:split], sync_state[split:]
        res = sync_grads(strategy, mesh, delta, res,
                         call=strategy.window_exchange if hier else None)
        if outer is None:
            torch._foreach_add_(anchor, delta)
            return res
        # the momentum is raveled in the JAX layout (conv kernels HWIO)
        new, m_flat = outer.apply_flat(
            [_to_jax_layout(a) for a in anchor],
            [_to_jax_layout(d) for d in delta], m_flat)
        for a, t in zip(anchor, new):
            a.copy_(_from_jax_layout(t))
        return torch.cat([res, m_flat])

    def run(params, state, opt, step0, images, labels, sync_state,
            fault_arm=0.0):
        k = images.shape[0]
        if k % h:
            raise ValueError(
                f"dispatch of {k} steps is not a multiple of "
                f"sync_every={h}: every compiled dispatch must end on a "
                f"window boundary so params leave replicated")
        names = jax_order(params)
        anchor = [params[a][b] for a, b in names]
        losses, oks, mets = [], [], []
        for w in range(k // h):
            delta = [torch.zeros_like(a, requires_grad=False)
                     for a in anchor]
            for i in range(w * h, (w + 1) * h):
                loss, state, ok, met = local_step(
                    names, anchor, delta, state, opt, step0 + i, images[i],
                    labels[i], fault_arm)
                losses.append(loss)
                oks.append(ok)
                mets.append(met)
            sync_state = boundary(anchor, delta, sync_state)
        return state, losses, oks, mets, sync_state

    return run


def make_multi_step(cfg: TrainConfig, strategy=None, mesh=None, *,
                    fused_bn: bool | None = None):
    """``fn(params, state, opt, step0, images, labels, sync_state=None) ->
    (state, losses, oks, mets, sync_state)`` over K stacked batches (K, B,
    ...): K optimizer steps, the i-th seeded by ``step0 + i``, so the
    trajectory equals K single steps; ``fault_arm`` is the host's arming of
    the fault taps for the K steps.  Under a mesh the K losses, health
    flags and scalars are averaged over the ranks in one all-reduce.  With
    ``sync_every > 1`` the K steps are K/H windows (``_make_window_run``).
    """
    if cfg.sync_every > 1:
        run = _make_window_run(cfg, strategy, mesh, fused_bn)
    else:
        step = make_train_step(cfg, strategy, mesh, fused_bn=fused_bn)

        def run(params, state, opt, step0, images, labels, sync_state,
                fault_arm=0.0):
            losses, oks, mets = [], [], []
            for i in range(images.shape[0]):
                loss, state, ok, met, sync_state = step(
                    params, state, opt, step0 + i, images[i], labels[i],
                    sync_state, fault_arm)
                losses.append(loss)
                oks.append(ok)
                mets.append(met)
            return state, losses, oks, mets, sync_state
    group = mesh_group(mesh) if mesh is not None else None

    def multi_step(params, state, opt, step0, images, labels,
                   sync_state=None, fault_arm=0.0):
        state, losses, oks, mets, sync_state = run(
            params, state, opt, step0, images, labels, sync_state,
            fault_arm)
        losses, oks, mets = (torch.stack(losses), torch.stack(oks),
                             torch.stack(mets))
        if mesh is not None:
            k = losses.shape[0]
            flat = torch.cat([losses.float(), oks, mets.reshape(-1)])
            dist.all_reduce(flat, group=group)
            flat /= mesh.size()
            losses, oks, mets = flat[:k], flat[k:2 * k], \
                flat[2 * k:].view(k, 2)
        return state, losses, oks, mets, sync_state

    return multi_step


def _trainable(params: dict, dev: torch.device) -> dict:
    return {k: {n: t.detach().to(dev, torch.float32).clone()
                .requires_grad_(True) for n, t in v.items()}
            for k, v in params.items()}


def _buffers(state: dict, dev: torch.device) -> dict:
    return {k: {n: t.detach().to(dev, torch.float32).clone()
                for n, t in v.items()} for k, v in state.items()}


class Trainer:
    """Owns this rank's float32 ``params``, BN running ``state``, SGD
    optimizer and sync state, and drives epochs with the reference's metric
    windows (reference main.py:84-135).

    A strategy other than ``none`` syncs over ``mesh``: given, or built as
    the JAX trainer builds it (``("data",)`` over every rank, or ``("dcn",
    "ici")`` of shape ``(dcn_size, world // dcn_size)`` for
    ``hierarchical``) on the default process group, made first of one rank
    when none exists.  ``n_replicas`` is the mesh's size.  ``num_devices``
    other than the world size is refused: one process drives one device
    (``launch.py --nproc-per-node N``).

    ``device`` defaults to ``"cuda"`` (``cuda:{LOCAL_RANK}``) and raises
    without a GPU unless ``"cpu"`` is asked for.  Params are drawn by the
    port's own ``vgg.init`` from ``cfg.seed`` (not the JAX package's draws)
    and broadcast from rank 0; ``load_state`` takes params, BN state,
    momentum and a residual carried from a JAX run (convert.py)."""

    def __init__(self, cfg: TrainConfig, mesh=None,
                 num_devices: int | None = None, *,
                 device: str | torch.device = "cuda"):
        validate_train_cfg(cfg)
        self.cfg = cfg
        self.sync_plan = None
        self.strategy = strat.get(cfg.strategy)
        self.data_axes = getattr(self.strategy, "axes", None) or (DATA_AXIS,)
        if self.strategy.needs_mesh:
            if mesh is None:
                mesh = self._build_mesh(cfg, num_devices, device)
            self._check_mesh(cfg, mesh)
            self.device = ensure_process_group(device)
        else:
            one_process_per_device(num_devices)
            mesh = None
            self.device = resolve_device(device)
        self.mesh = mesh
        self.n_replicas = mesh.size() if mesh is not None else 1
        self.rank = dist.get_rank() if mesh is not None else 0
        self.group = mesh_group(mesh) if mesh is not None else None
        _apply_dcn(cfg, self.strategy)
        _apply_bucket_mb(cfg, self.strategy)
        _validate_overlap(cfg, self.strategy, self.mesh)
        strat.require_sync_window(
            sync_every=cfg.sync_every, max_sync_every=cfg.max_sync_every,
            mesh=self.mesh is not None, overlap=cfg.overlap,
            steps_per_loop=cfg.steps_per_loop, trainer="train",
            outer_opt=cfg.outer_opt, outer_momentum=cfg.outer_momentum,
            outer_lr=cfg.outer_lr)
        params, state = vgg.init(cfg.seed, cfg.model, device=self.device)
        self.params = _trainable(params, self.device)
        self.state = state
        self._broadcast_params()
        self.opt = make_optimizer(cfg, self.params)
        with monitor.compile_span(
                "train_step_build", key=(cfg.strategy, cfg.sync_every,
                                         self.n_replicas),
                strategy=cfg.strategy):
            self._multi_fn = make_multi_step(cfg, self.strategy, self.mesh)
        self.sync_state = self._init_sync_state()
        self._step = 0
        self.last_ok = None       # (K,) health flags of the last call
        self.last_metrics = None  # (K, 2) [grad-norm, param-norm]
        self._window_wire_bytes = self._compute_window_wire_bytes()
        # whether the fault taps are armed at all, decided at construction
        # as the JAX trainer decides its step's signature: a plan installed
        # later consumes no firing
        self._fault_sig = faults.step_plan() is not None

    def _compute_window_wire_bytes(self) -> int | None:
        """The float32 payload of one window-boundary exchange (the
        ``window_wire_bytes`` gauge): the shard-sized dcn hop for
        ``hierarchical`` (each bucket's ceil(bucket / n_ici) elements), the
        whole tree for the flat strategies; compression sends less.  None
        without windows."""
        if self.cfg.sync_every <= 1:
            return None
        leaves = self._leaves()
        if hasattr(self.strategy, "window_exchange"):
            n_ici = max(self.n_replicas // self.cfg.dcn_size, 1)
            return sum(
                4 * -(-sum(leaves[i].numel() for i in b) // n_ici)
                for b in strat.make_bucket_plan(leaves,
                                                self.strategy.bucket_bytes))
        return sum(4 * leaf.numel() for leaf in leaves)

    def _build_mesh(self, cfg: TrainConfig, num_devices, device):
        if len(self.data_axes) == 1:
            return make_mesh(num_devices, device=device)
        ensure_process_group(device)
        one_process_per_device(num_devices)
        n = dist.get_world_size()
        if n % cfg.dcn_size:
            raise ValueError(
                f"dcn_size {cfg.dcn_size} must divide the {n}-device fleet "
                f"for strategy {self.strategy.name!r}")
        return make_mesh(n, axis_names=self.data_axes,
                         axis_shape=(cfg.dcn_size, n // cfg.dcn_size),
                         device=device)

    def _check_mesh(self, cfg: TrainConfig, mesh) -> None:
        if len(self.data_axes) == 1:
            return
        if tuple(mesh.mesh_dim_names or ()) != self.data_axes:
            raise ValueError(
                f"strategy {self.strategy.name!r} needs a mesh with axes "
                f"{self.data_axes}, got {mesh.mesh_dim_names}")
        if axis_size(mesh, self.data_axes[0]) != cfg.dcn_size:
            raise ValueError(
                f"mesh {self.data_axes[0]!r} axis has size "
                f"{axis_size(mesh, self.data_axes[0])} but cfg.dcn_size is "
                f"{cfg.dcn_size}; pass a mesh matching the config (or "
                f"mesh=None to build one)")

    def _leaves(self) -> list[torch.Tensor]:
        return [self.params[k][n] for k, n in jax_order(self.params)]

    def _init_sync_state(self) -> torch.Tensor:
        """A stateful strategy's zero residual (empty otherwise), then,
        with a non-trivial ``outer_opt``, the zero outer momentum."""
        if getattr(self.strategy, "stateful", False):
            state = self.strategy.init_state(self._leaves(), self.n_replicas,
                                             device=self.device)
        else:
            state = torch.zeros(0, dtype=torch.float32, device=self.device)
        outer = strat.OuterOptimizer.of(self.cfg)
        if outer is not None:
            state = torch.cat([state, outer.init_flat(self._leaves(),
                                                      self.device)])
        return state

    def _broadcast_params(self) -> None:
        """Rank 0's params on every rank (torch DDP's construction-time
        broadcast); nothing to do without a mesh."""
        if self.mesh is None:
            return
        src = _broadcast_tree(self.params, self.group)
        with torch.no_grad():
            for k, v in self.params.items():
                for n, p in v.items():
                    p.copy_(src[k][n])

    def load_state(self, params: dict, state: dict | None = None,
                   momentum: dict | None = None,
                   sync_state: torch.Tensor | None = None) -> None:
        """Take params (the port's nested dict, e.g. from
        ``convert.from_jax_vgg``; rank 0's are broadcast), optionally this
        rank's BN running state, the momentum buffers
        (``convert.from_jax_sgd_state``) and this rank's residual
        (``convert.from_jax_sync_state``)."""
        if {k: sorted(v) for k, v in params.items()} != \
                {k: sorted(v) for k, v in self.params.items()}:
            raise ValueError("params do not match the model's parameter "
                             "names")
        self.params = _trainable(params, self.device)
        self._broadcast_params()
        if state is not None:
            self.state = _buffers(state, self.device)
        self.opt = make_optimizer(self.cfg, self.params)
        if momentum is not None:
            bufs = vgg.flatten(_buffers(momentum, self.device))
            for name, p in vgg.flatten(self.params).items():
                self.opt.state[p]["momentum_buffer"] = bufs[name]
        if sync_state is not None:
            if sync_state.shape != self.sync_state.shape:
                raise ValueError(f"sync_state of shape "
                                 f"{tuple(sync_state.shape)}, want "
                                 f"{tuple(self.sync_state.shape)}")
            self.sync_state = sync_state.to(self.device, torch.float32)

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

    @property
    def opt_state(self) -> dict:
        """The optimizer state as a tree: ``{"momentum": {layer: {name:
        buffer or None}}}``, the live SGD momentum buffers (None before a
        leaf's first step), for the checkpoint and the training sentry."""
        return {"momentum": {
            k: {n: self.opt.state.get(p, {}).get("momentum_buffer")
                for n, p in v.items()} for k, v in self.params.items()}}

    @opt_state.setter
    def opt_state(self, tree: dict) -> None:
        """Install momentum buffers (a tensor is copied into the live buffer
        when one exists; None removes the buffer, so the next step starts
        it from its gradient, as a fresh optimizer does)."""
        mom = tree["momentum"]
        for k, v in self.params.items():
            for n, p in v.items():
                buf = mom[k][n]
                st = self.opt.state[p]
                if buf is None:
                    st.pop("momentum_buffer", None)
                    continue
                live = st.get("momentum_buffer")
                if live is buf:
                    continue
                if live is not None and live.shape == buf.shape:
                    with torch.no_grad():
                        live.copy_(buf)
                else:
                    st["momentum_buffer"] = buf.detach().to(
                        self.device, torch.float32).clone()

    def _to_device(self, images, labels):
        return (torch.as_tensor(np.asarray(images)).to(self.device),
                torch.as_tensor(np.asarray(labels)).to(self.device))

    def train_step(self, images, labels) -> torch.Tensor:
        """One optimizer step on this rank's (B, 32, 32, 3) uint8 batch;
        returns the loss averaged over the ranks as a 0-dim tensor (not
        fetched to the host)."""
        return self.train_steps(np.asarray(images)[None],
                                np.asarray(labels)[None])[0]

    def train_steps(self, images, labels) -> torch.Tensor:
        """``K = images.shape[0]`` steps over this rank's stacked batches
        (K, B, ...), numpy or tensors; returns the K losses averaged over
        the ranks (a device tensor).  The same trajectory as K
        ``train_step`` calls."""
        k = np.shape(images)[0]
        if self.cfg.sync_every > 1 and k % self.cfg.sync_every:
            raise ValueError(
                f"train_steps got {k} steps with sync_every="
                f"{self.cfg.sync_every}: dispatches must be window-"
                f"aligned (k % H == 0) so params leave the step "
                f"replicated; stack window-multiple batches (train_step's "
                f"K=1 path is likewise unavailable under windows)")
        faults.maybe_delay(self._step, k)  # a straggler plan's sleep
        if not isinstance(images, torch.Tensor):
            images, labels = self._to_device(images, labels)
        # the taps' one-shot arming for the K steps (only when a step plan
        # was installed before construction: _fault_sig)
        arm = faults.arm_window(self._step, k) if self._fault_sig else 0.0
        t0 = time.perf_counter()
        (self.state, losses, self.last_ok, self.last_metrics,
         self.sync_state) = self._multi_fn(
            self.params, self.state, self.opt, self._step, images,
            labels.long(), self.sync_state, arm)
        self._step += k
        faults.maybe_crash(self._step, k)  # an injected crash
        tel = telemetry.active()
        if tel is not None:
            telemetry.emit_train_steps(
                tel, t0, self._step - k, k, *tracing.lazy_host(
                    losses, self.last_ok, self.last_metrics))
            if self.cfg.sync_every > 1:
                telemetry.emit_sync_windows(
                    tel, t0, self._step - k, k, self.cfg.sync_every,
                    wire_bytes=self._window_wire_bytes)
        return losses

    def train_epoch(self, loaders, epoch: int, *, log=print, on_step=None):
        """One epoch with the reference's metric windows (loss/20 iters,
        time/40 iters excluding iteration 0); returns (LossMeter,
        IterTimeMeter).

        ``loaders``: this rank's DataLoader (or a one-element list): one
        process drives one replica.  Batches are stacked into
        ``steps_per_loop`` chunks (a ragged final batch flushes early) and
        copied to the device on a prefetch thread, so the copy of the next
        chunk overlaps the current one's compute.  Each chunk's losses are
        fetched at its end, as the reference's ``loss.item()`` does every
        iteration.  ``on_step(step)`` fires before each chunk."""
        if not isinstance(loaders, (list, tuple)):
            loaders = [loaders]
        if len(loaders) != 1:
            raise ValueError(f"got {len(loaders)} loaders for the one "
                             f"replica this process drives")
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
            with tracing.annotate_step(self._step):
                losses = self.train_steps(images, labels).cpu().numpy()
            per_step = (time.perf_counter() - begin) / k
            for loss_val in losses:
                record(batch_idx, float(loss_val), per_step)
                batch_idx += 1
        return loss_meter, time_meter

    def eval_state(self) -> dict:
        """Rank 0's BN running state (a copy), for evaluation: the JAX
        ``rank0_state``.  Under a mesh every rank must call it (a
        broadcast)."""
        if self.mesh is None:
            return _buffers(self.state, self.device)
        return _buffers(_broadcast_tree(self.state, self.group),
                        self.device)

    def check_consistency(self) -> None:
        """The data-parallel invariants (utils/debug.py): params and
        momentum bitwise equal on every rank, and params finite.  Under
        ``sync_every > 1`` the momentum is each rank's own by design, so
        only the params are compared.  Every rank must call it under a
        mesh."""
        if self.mesh is not None:
            tree = {"params": self.params}
            if self.cfg.sync_every == 1:
                tree["momentum"] = self.momentum()
            dbg.assert_replicas_in_sync(tree, self.group,
                                        what="params/momentum")
        dbg.assert_finite(self.params, what="params")

    # -- later slices -----------------------------------------------------
    def rebuild(self, *args, **kwargs):
        raise not_ported("Trainer.rebuild (elastic resize)",
                         ELASTIC_SLICE)
