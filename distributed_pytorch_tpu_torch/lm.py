"""LM trainer: the port of the JAX package's lm.py, on one device or data
parallel over ``torch.distributed``, one process a rank and a device.

The JAX trainer composes data, expert, sequence, tensor and pipeline axes
over one mesh; the port has the data axis (``dp``).  A step is the JAX
``make_lm_train_step`` with every other axis of size 1:

- the transformer forward (``models/transformer.apply``) in
  ``compute_dtype`` with float32 params (embedding rows cast at lookup,
  weights cast at use), flash attention by default (hand-written kernels
  K2, K3 and K4 on the GPU, ops/attention.py), the dense projections
  through the int8 matmul with ``matmul_dtype="int8"`` (kernel K5,
  ops/quantized.py), each layer recomputed in the backward with
  ``remat="full"`` or ``"selective"``, and MoE layers (ops/moe.py) where
  ``cfg.model.n_experts > 0``;
- the masked cross-entropy head (``ops/losses.head_loss``, dense or, with
  ``loss_impl="chunked"``, streamed over ``loss_chunk`` vocabulary rows),
  the loss being ``ce_sum / max(n_total, 1) + aux_w * aux`` with
  ``n_total`` the valid-token count of the whole global batch, counted
  before the backward, and ``aux`` the MoE aux summed over the layers;
- ``grad_accum = A`` microbatches split interleaved (microbatch j holds
  rows j, j + A, ...), each its own MoE routing group with
  ``aux_w = aux_coef / A``, their gradients summed;
- the update of ``optax.chain(clip_by_global_norm(grad_clip),
  adamw(schedule, b1, b2, weight_decay))``: global-norm clip, Adam with
  bias correction (eps 1e-8), weight decay on every leaf, the LR schedule
  read at the step count before the update.  The port updates params and
  moments in place where the JAX step returns new trees.

**Data parallel** (``dp = N``, the world size of the default process
group: ``launch.py --nproc-per-node N``): each rank takes its contiguous
``B / N`` rows of the global batch (``train_step`` is given them), which
is how the JAX mesh shards the batch over ``data``; its own interleaved
microbatches are then exactly its shard of JAX's global interleaved split.
The valid-token count is all-reduced before the backward, so every rank
divides by the GLOBAL ``n_total``.  Each rank's loss is ``ce_sum_r /
n_total + aux_w * aux_r / N``: summed over the ranks it is the JAX loss
(``ce_sum`` summed, the aux averaged, as the JAX step's ``psum`` and
``pmean`` do), and so is its gradient.  The gradients and the loss are
summed over the ranks in ONE collective after the backward: ``ddp``'s
flat all-reduce (``parallel.strategies.flat_all_reduce``) without its
mean.  A step issues two all-reduces: the count and the flat sum.  The
update then runs on every rank on the same summed gradients, so replicas
stay bitwise equal (rank 0's params are broadcast at construction).  At
world size 1 both collectives are the identity, and the step is bitwise
the step without a process group.

``LMTrainConfig`` keeps every field of the JAX config so configs cross
between the packages unchanged; a non-default value of a field that
belongs to a later slice raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .models import transformer as tfm
from .ops import losses
from .ops.nn import IGNORE_INDEX, step_metrics
from .parallel.mesh import (ensure_process_group, make_mesh, mesh_group,
                            one_process_per_device)
from .parallel.strategies import flat_all_reduce
from .utils.device import resolve_device

IGNORE = IGNORE_INDEX  # target id excluded from the loss (padding)

SYNC_SLICE, DURABILITY_SLICE = tfm.SYNC_SLICE, tfm.DURABILITY_SLICE
PARALLEL_SLICE, PLANNING_SLICE = tfm.PARALLEL_SLICE, tfm.PLANNING_SLICE
ADAM_EPS = 1e-8  # optax.adamw's default


@dataclass
class LMTrainConfig:
    """The JAX package's ``LMTrainConfig``, field for field (see its
    docstrings for what each knob does there)."""
    model: tfm.TransformerConfig = field(
        default_factory=lambda: tfm.PRESETS["LM-tiny"])
    lr: float = 3e-4
    warmup_steps: int = 0     # linear LR warmup
    decay_steps: int = 0      # cosine decay horizon (0 = constant LR)
    min_lr_ratio: float = 0.1
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    aux_coef: float = 0.01  # MoE load-balance loss weight
    compute_dtype: str | None = "bfloat16"
    seed: int = 1
    dp: int = 1
    sp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    dcn_size: int = 1
    dcn_compress: str | None = None
    bucket_mb: float | None = None
    sync_plan: str | None = None
    autotune_profile: Any = None
    sync_route: str | None = None
    pp_size: int = 0
    microbatches: int = 0
    interleave: int = 1
    pp_remat_block: int | None = 0
    fsdp: bool = False
    fsdp_gather_dtype: str | None = None
    matmul_dtype: str | None = None
    overlap: bool = False
    grad_accum: int = 1
    loss_impl: str = "dense"
    loss_chunk: int | None = None
    remat: str = "none"
    sync_every: int = 1
    staleness: int = 0
    max_sync_every: int = 1
    outer_opt: str | None = None
    outer_momentum: float = 0.9
    outer_lr: float = 1.0
    sync_every_per_slice: tuple | None = None

    @property
    def dtype(self) -> torch.dtype | None:
        """compute_dtype resolved to a torch dtype (None = float32)."""
        return getattr(torch, self.compute_dtype) if self.compute_dtype \
            else None

    seq_layout: str = "zigzag"


# Fields whose non-default values belong to a later slice: name -> (the
# value that means "off", the slice).
_LATER = {
    **{n: (1, SYNC_SLICE) for n in ("dcn_size", "sync_every",
                                    "max_sync_every")},
    **{n: (1, PARALLEL_SLICE) for n in ("sp", "tp", "pp", "ep",
                                        "interleave")},
    **{n: (None, SYNC_SLICE) for n in (
        "dcn_compress", "bucket_mb", "fsdp_gather_dtype", "outer_opt",
        "sync_every_per_slice")},
    **{n: (None, PLANNING_SLICE) for n in ("sync_plan", "sync_route")},
    "fsdp": (False, SYNC_SLICE),
    "overlap": (False, SYNC_SLICE),
    "staleness": (0, SYNC_SLICE),
    "pp_size": (0, PARALLEL_SLICE),
    "microbatches": (0, PARALLEL_SLICE),
}


def validate_lm_cfg(cfg: LMTrainConfig) -> None:
    """The JAX package's value checks for the data axis and one device,
    then a ``NotImplementedError`` for any knob of a later slice."""
    if cfg.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {cfg.grad_accum}")
    if cfg.dp < 1:
        raise ValueError(f"dp must be >= 1, got {cfg.dp}")
    pipelined = cfg.pp > 1 or cfg.pp_size > 0
    if cfg.matmul_dtype is not None:
        if cfg.matmul_dtype != "int8":
            raise ValueError(f"matmul_dtype must be None or 'int8', got "
                             f"{cfg.matmul_dtype!r}")
        if pipelined:
            raise ValueError(
                "matmul_dtype does not compose with pipeline parallelism "
                "(pp/pp_size): the stage runners call the block body "
                "directly without the matmul_dtype plumbing; drop one")
    if cfg.loss_impl not in ("dense", "chunked"):
        raise ValueError(f"loss_impl must be 'dense' or 'chunked', got "
                         f"{cfg.loss_impl!r}")
    if cfg.loss_chunk is not None:
        if cfg.loss_impl != "chunked":
            raise ValueError(
                f"loss_chunk={cfg.loss_chunk} only applies to "
                "loss_impl='chunked'; the dense head has no chunk size "
                "(set loss_impl='chunked' or drop loss_chunk)")
        v = cfg.model.vocab_size
        if cfg.loss_chunk <= 0 or v % cfg.loss_chunk:
            raise ValueError(
                f"loss_chunk={cfg.loss_chunk} must be a positive divisor "
                f"of the per-rank vocab rows ({v}) — the streaming scan "
                "needs equal-sized chunks")
    if cfg.remat not in ("none", "full", "selective"):
        raise ValueError(f"remat must be 'none', 'full' or 'selective', got "
                         f"{cfg.remat!r}")
    if cfg.remat != "none" and pipelined:
        raise ValueError(
            "remat does not compose with pipeline parallelism (pp/pp_size): "
            "the pipeline schedulers own their own rematerialization; drop "
            "one")
    m = cfg.model
    if m.moe_dispatch_bits != "f32" or m.moe_a2a_chunks > 1:
        # the a2a knobs act only where the MoE layer crosses a mesh axis
        if not m.n_experts:
            raise ValueError(
                f"moe_dispatch_bits={m.moe_dispatch_bits!r}/"
                f"moe_a2a_chunks={m.moe_a2a_chunks} configure the "
                f"expert all_to_all of an MoE model; this model is dense "
                f"(n_experts=0)")
        if cfg.ep == 1 and cfg.tp == 1:
            raise ValueError(
                f"moe_dispatch_bits={m.moe_dispatch_bits!r}/"
                f"moe_a2a_chunks={m.moe_a2a_chunks} shape the "
                f"expert all_to_all wire, but ep=1 and tp=1 route "
                f"experts locally (no exchange to compress or overlap) "
                f"— raise ep or tp, or drop the knobs")
    for name, (off, where) in _LATER.items():
        value = getattr(cfg, name)
        if value != off:
            raise tfm.not_ported(f"LMTrainConfig.{name}={value!r}", where)


def make_schedule(cfg: LMTrainConfig):
    """The LR as a function of the optimizer step count (0 for the first
    update), with optax's values: constant, linear warmup from 0, or
    linear warmup then cosine decay to ``min_lr_ratio * lr`` at
    ``decay_steps`` (warmup included)."""
    lr, warm, decay = cfg.lr, cfg.warmup_steps, cfg.decay_steps

    def linear(count):  # optax.linear_schedule(0, lr, warm)
        if warm <= 0:
            return 0.0
        c = min(max(count, 0), warm)
        return (0.0 - lr) * (1 - c / warm) + lr

    if decay <= 0 and warm <= 0:
        return lambda count: lr
    if decay <= 0:
        return linear
    span = decay - warm
    if span <= 0:
        raise ValueError(f"decay_steps {decay} must exceed warmup_steps "
                         f"{warm} (the cosine phase needs positive length)")
    alpha = 0.0 if lr == 0.0 else cfg.min_lr_ratio

    def schedule(count):  # optax.warmup_cosine_decay_schedule
        if count < warm:
            return linear(count)
        c = min(count - warm, span)
        cosine = 0.5 * (1 + math.cos(math.pi * c / span))
        return lr * ((1 - alpha) * cosine + alpha)

    return schedule


def init_opt_state(params: dict[str, torch.Tensor]) -> dict:
    """Adam state: the update count and float32 first / second moments."""
    return {"count": 0,
            "mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()}}


def make_optimizer(cfg: LMTrainConfig):
    """``update(params, grads, opt_state, grad_sq_sum)``: the JAX package's
    ``chain(clip_by_global_norm, adamw)`` applied in place.

    The clip is optax's, not ``torch.nn.utils.clip_grad_norm_``: gradients
    are scaled to ``(g / norm) * grad_clip`` only when ``norm >=
    grad_clip``, with no epsilon.  AdamW decays every leaf (norms and the
    tied embedding included), as optax's unmasked ``adamw`` does."""
    schedule = make_schedule(cfg)
    b1, b2, wd, clip = cfg.b1, cfg.b2, cfg.weight_decay, cfg.grad_clip

    @torch.no_grad()
    def update(params: dict, grads: dict, opt_state: dict,
               grad_sq_sum: torch.Tensor) -> None:
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        mu = [opt_state["mu"][n] for n in names]
        nu = [opt_state["nu"][n] for n in names]
        norm = grad_sq_sum.sqrt()
        keep = norm < clip
        torch._foreach_div_(g, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(g, torch.where(keep, 1.0, clip))
        lr = schedule(opt_state["count"])  # read before the count moves
        count = opt_state["count"] + 1
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - b2))
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, torch._foreach_mul(p, wd))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p, upd)
        opt_state["count"] = count

    return update


def _micro_split(x: torch.Tensor, a: int) -> torch.Tensor:
    """(B, S) -> (A, B/A, S), INTERLEAVED: microbatch j = rows j, j+A, ...
    (B is this rank's rows under data parallelism)."""
    b = x.shape[0]
    if b % a:
        raise ValueError(f"batch {b} not divisible into "
                         f"grad_accum={a} microbatches")
    return x.reshape(b // a, a, -1).transpose(0, 1)


def _loss_fn(cfg: LMTrainConfig, attn_impl: str, params, tokens, targets,
             n_total, aux_w, n_ranks: int = 1):
    """This rank's share of the step's loss: ``ce_sum / n_total`` (the
    GLOBAL count) plus ``aux_w`` times this rank's aux over ``n_ranks``
    (the JAX ``pmean`` of the aux over the data axis, taken by the sum
    over ranks)."""
    head = partial(losses.head_loss, targets=targets,
                   loss_impl=cfg.loss_impl, loss_chunk=cfg.loss_chunk)
    (ce_sum, _), aux = tfm.apply(params, tokens, cfg=cfg.model,
                                 dtype=cfg.dtype, attn_impl=attn_impl,
                                 return_aux=True, head_fn=head,
                                 matmul_dtype=cfg.matmul_dtype,
                                 remat=cfg.remat)
    return ce_sum / n_total.clamp_min(1) + aux_w * (aux * (1.0 / n_ranks))


def make_lm_train_step(cfg: LMTrainConfig, attn_impl: str = "flash",
                       mesh=None):
    """``step(params, opt_state, tokens, targets) -> (loss, ok, met)``,
    updating ``params`` (float32 leaves that require grad) and
    ``opt_state`` in place.  tokens/targets are (B, S) integer tensors on
    the params' device: this rank's rows when ``mesh`` (the data-parallel
    ``DeviceMesh``) is given.  The loss is the
    global batch's (every rank returns the same).  ``ok`` is 1.0 when the
    loss and the gradient sum of squares are finite; ``met`` is
    [grad-norm, param-norm] (the gradient's before the clip, the params'
    after the update)."""
    validate_lm_cfg(cfg)
    update = make_optimizer(cfg)
    a = cfg.grad_accum
    n_ranks = 1 if mesh is None else mesh.size()
    loss_fn = partial(_loss_fn, cfg, attn_impl, n_ranks=n_ranks)

    def step(params, opt_state, tokens, targets):
        for p in params.values():
            p.grad = None
        n_total = (targets != IGNORE).sum().float()
        if mesh is not None:  # the global count, before the backward
            dist.all_reduce(n_total, group=mesh_group(mesh))
        if a == 1:
            loss = loss_fn(params, tokens, targets, n_total, cfg.aux_coef)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), device=tokens.device)
            for tk, tg in zip(_micro_split(tokens, a),
                              _micro_split(targets, a)):
                loss_i = loss_fn(params, tk, tg, n_total, cfg.aux_coef / a)
                loss_i.backward()
                loss = loss + loss_i.detach()
        grads = {n: p.grad for n, p in params.items()}
        if mesh is not None:  # gradients and loss summed over the ranks
            *summed, loss = flat_all_reduce(list(grads.values()) + [loss],
                                            mesh)
            grads = dict(zip(grads, summed))
        gsq = torch.stack(torch._foreach_norm(list(grads.values()))
                          ).square().sum()
        ok = (torch.isfinite(loss) & torch.isfinite(gsq)).float()
        update(params, grads, opt_state, gsq)
        for p in params.values():
            p.grad = None
        return loss, ok, step_metrics(gsq, params.values())

    return step


def make_lm_eval_step(cfg: LMTrainConfig, attn_impl: str = "flash",
                      mesh=None):
    """Forward-only masked CE: ``(params, tokens, targets) -> (ce_sum,
    count)``, with the training step's ``matmul_dtype`` and head (the MoE
    aux is no part of it, as in the JAX eval step); no remat (there is no
    backward to keep activations for).  Under ``mesh`` both are summed
    over the ranks, each given its own rows."""
    validate_lm_cfg(cfg)

    @torch.no_grad()
    def eval_step(params, tokens, targets):
        head = partial(losses.head_loss, targets=targets,
                       loss_impl=cfg.loss_impl, loss_chunk=cfg.loss_chunk)
        ce, n = tfm.apply(params, tokens, cfg=cfg.model, dtype=cfg.dtype,
                          attn_impl=attn_impl, head_fn=head,
                          matmul_dtype=cfg.matmul_dtype)
        if mesh is not None:
            ce, n = flat_all_reduce([ce.float(), n.float()], mesh)
        return ce, n

    return eval_step


class LMTrainer:
    """Owns this rank's float32 ``params`` and Adam ``opt_state``.

    ``cfg.dp = N > 1`` trains data parallel over ``mesh`` (given, or made
    by ``parallel.mesh.make_mesh`` over the default process group, whose
    world size must be N: one process a device, ``launch.py
    --nproc-per-node N``; otherwise ``NotImplementedError`` naming the
    launcher).  A mesh may be given at ``dp = 1`` too: a gang of one,
    whose step issues its collectives over a one-rank group.  Every rank
    calls ``train_step`` with its own ``B / N`` rows and ``evaluate`` with
    its own batches.

    ``device`` defaults to ``"cuda"`` (``cuda:{LOCAL_RANK}`` under a mesh)
    and raises without a GPU unless ``"cpu"`` is asked for.  Params are
    drawn by the port's own ``init`` from ``cfg.seed`` (not the JAX
    package's draws), rank 0's broadcast; ``load_state`` takes params and
    optimizer state carried from a JAX run (convert.py).  ``attn_impl``
    chooses the attention of the forward (``"flash"``, the JAX package's
    default, or ``"reference"``)."""

    def __init__(self, cfg: LMTrainConfig,
                 device: str | torch.device = "cuda",
                 attn_impl: str = "flash", mesh=None):
        validate_lm_cfg(cfg)
        self.cfg = cfg
        if mesh is None and cfg.dp > 1:
            one_process_per_device(cfg.dp)  # a gang of dp processes
            mesh = make_mesh(cfg.dp, device=device)
        if mesh is not None:
            if mesh.size() != cfg.dp:
                raise ValueError(f"mesh has {mesh.size()} ranks, config "
                                 f"wants dp={cfg.dp}")
            self.device = ensure_process_group(device)
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.rank = dist.get_rank() if mesh is not None else 0
        self.attn_impl = attn_impl
        self.params = self._leaves(tfm.init(cfg.seed, cfg.model,
                                            device=self.device))
        self.opt_state = init_opt_state(self.params)
        self.step_fn = make_lm_train_step(cfg, attn_impl, mesh)
        self._eval_fn = make_lm_eval_step(cfg, attn_impl, mesh)
        self._step = 0
        self.last_ok = None       # health flag of the last step (tensor)
        self.last_metrics = None  # [grad-norm, param-norm] of the last step

    def _leaves(self, params: dict) -> dict[str, torch.Tensor]:
        """Float32 leaves on this device that require grad; rank 0's
        values on every rank of the mesh."""
        out = {n: p.detach().to(self.device, torch.float32).clone()
               for n, p in params.items()}
        if self.mesh is not None:
            group = mesh_group(self.mesh)
            src = dist.get_global_rank(group, 0) if group is not None else 0
            for t in out.values():
                dist.broadcast(t, src=src, group=group)
        return {n: t.requires_grad_(True) for n, t in out.items()}

    def load_state(self, params: dict, opt_state: dict | None = None
                   ) -> None:
        """Take params (the port's flat dict, e.g. from
        ``convert.from_jax_params``) and optionally the Adam state
        (``convert.from_jax_opt_state``); the step count follows the
        optimizer state's, or restarts at 0 without one."""
        if sorted(params) != sorted(self.params):
            raise ValueError("params do not match the model's parameter "
                             "names")
        self.params = self._leaves(params)
        if opt_state is None:
            self.opt_state = init_opt_state(self.params)
        else:
            self.opt_state = {
                "count": int(opt_state["count"]),
                **{m: {n: opt_state[m][n].detach().to(
                    self.device, torch.float32).clone() for n in self.params}
                   for m in ("mu", "nu")}}
        self._step = self.opt_state["count"]

    def _batch(self, tokens, targets):
        return (torch.as_tensor(np.asarray(tokens), device=self.device).long(),
                torch.as_tensor(np.asarray(targets), device=self.device)
                .long())

    def train_step(self, tokens: np.ndarray, targets: np.ndarray):
        """One optimizer step on a (B, S) batch (this rank's rows under a
        mesh); returns the global batch's loss as a 0-dim tensor (not
        fetched to the host)."""
        tokens, targets = self._batch(tokens, targets)
        loss, self.last_ok, self.last_metrics = self.step_fn(
            self.params, self.opt_state, tokens, targets)
        self._step += 1
        return loss

    def evaluate(self, batches) -> dict[str, float]:
        """Held-out loss/perplexity over an iterable of (tokens, targets)
        (this rank's rows of each batch under a mesh: every rank calls
        it, and every rank gets the global figures)."""
        total, count = 0.0, 0
        for tokens, targets in batches:
            ce, n = self._eval_fn(self.params, *self._batch(tokens, targets))
            total += float(ce)
            count += int(n)
        loss = total / max(count, 1)
        return {"loss": loss, "ppl": float(np.exp(min(loss, 30.0))),
                "tokens": count}

    # -- later slices -----------------------------------------------------
    def save_checkpoint(self, *args, **kwargs):
        raise tfm.not_ported("LMTrainer.save_checkpoint", DURABILITY_SLICE)

    def maybe_restore(self, *args, **kwargs):
        raise tfm.not_ported("LMTrainer.maybe_restore", DURABILITY_SLICE)

    def flush_checkpoints(self):
        raise tfm.not_ported("LMTrainer.flush_checkpoints", DURABILITY_SLICE)

    def rebuild(self, *args, **kwargs):
        raise tfm.not_ported("LMTrainer.rebuild (elastic resize)",
                             DURABILITY_SLICE)
