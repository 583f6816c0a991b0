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

**The sync knobs.**  ``fsdp`` (ZeRO-3) shards each parameter and its Adam
moments over the slice-local ``data`` axis along the dimension the JAX
``param_specs`` chooses: the forward all-gathers each sharded weight
(``_FsdpGather``; int8 or int4 on the wire with ``fsdp_gather_dtype``, a
straight-through gather) and its backward reduce-scatters the gradient,
so each rank holds its shard's sum.  ``dcn_size = S > 1`` factors the
ranks into a ``("dcn", "data")`` mesh of S slices and syncs the gradients
by the JAX two-level reduction (``_two_level_sync``): a reduce-scatter
over ``data``, a shard-sized exchange over ``dcn`` (the int8 or int4 ring
with an error-feedback residual, ``sync_state``, under ``dcn_compress``),
an all-gather over ``data``, in ``bucket_mb`` buckets where JAX buckets.
``overlap`` streams both through the layer-group boundaries of
``transformer.apply``: each group's gathers move to its boundary, and its
reduce-scatters and dcn exchange run inside the backward right after the
group's backward, on a side stream on the card
(``parallel.strategies._InFlight``), the step bitwise the non-overlapped
one where the sums are (every sum of two addends).  The global-norm clip
sums each sharded leaf's squares over ``data`` and counts each replicated
leaf once.  Without these knobs a ``dp`` step is the flat all-reduce above,
unchanged.

**The sync windows** (``sync_every = H > 1``, which needs ``dcn_size >=
2``): the slices train apart for H steps and exchange the sum of their
updates (``LMWindowSteps``).  ``params`` hold the anchor, the last
exchanged point; each rank keeps its slice's delta and Adam state, steps
at ``anchor + delta`` on a gradient synced within its slice alone, and at
each boundary the slices' deltas are averaged through the two-level sync
(its residual under ``dcn_compress``) and move the anchor, or move it
through the DiLoCo outer optimizer (``outer_opt``).  ``staleness = S``
applies the exchange S steps after it launches; ``sync_every_per_slice``
lets a slice skip boundaries.  The JAX window step's gradient carries an
extra factor (``n_data`` on each leaf not sharded over ``data``); the port
steps on the documented one, each slice's gradient of its own tokens at
the full-batch rate.

**K steps a call.**  ``LMTrainer.train_steps`` takes K stacked batches
(K, B, S) and runs the step K times, the trajectory of K ``train_step``
calls; it returns the K losses (the JAX ``make_lm_multi_step`` scan).

**Telemetry** (utils/telemetry.py): with it on, each ``train_step`` emits
an ``lm_train_step`` span (host dispatch time), the step's ``loss``,
``grad_norm`` and ``param_norm`` gauges fetched in one copy after the
dispatch, and at a window boundary a ``sync_window`` span with its
``window_wire_bytes`` gauge (and the outer optimizer's gauges);
``train_steps`` emits one ``lm_train_steps`` span and K of each gauge.
With it off nothing is fetched and no operation is added.

**Checkpoints and faults** (utils/checkpoint.py, utils/faults.py):
``save_checkpoint`` writes params, Adam state and the step (one whole-tree
npz on a background thread, or with ``sharded=True`` each rank's own
pieces), ``maybe_restore`` takes the newest of either format back.  Around
each step the host runs the fault hooks (a straggler plan's sleep, the
taps' arming, an injected crash after it); a fired tap poisons one
gradient leaf or scales the loss after the backward and before the sync.
``tighten_grad_clip`` is the training sentry's escalation.

**Rebuild** (``LMTrainer.rebuild(**overrides)``): the step rebuilt in
place with ``LMTrainConfig`` overrides (``sync_every`` and
``sync_every_per_slice``: the monitor's ``SyncRelaxHook``; ``fsdp``, the
clip, ...), the params, Adam state and step carried across over the
group: ZeRO-3 shards gathered and re-cut, a window's per-slice Adam row
collapsed to slice 0's (broadcast over ``dcn``); the residual, the window
delta and the outer momentum start again.  A pipeline config refuses, and
so does a change of ``dp``: one process drives one device, so a gang
changes size by drain and re-rendezvous (``launch.py --elastic``).

``LMTrainConfig`` keeps every field of the JAX config so configs cross
between the packages unchanged; a non-default value of a field that
belongs to a later slice raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .models import transformer as tfm
from .ops import losses
from .ops.nn import IGNORE_INDEX, step_metrics
from .parallel import context as pctx
from .parallel import strategies as strat
from .parallel.mesh import (DATA_AXIS, ensure_process_group, make_mesh,
                            mesh_group, one_process_per_device)
from .parallel.strategies import flat_all_reduce
from .utils import faults, monitor, telemetry, tracing
from .utils.device import resolve_device

IGNORE = IGNORE_INDEX  # target id excluded from the loss (padding)

PLANNING_SLICE = tfm.PLANNING_SLICE
COMPOSE_SLICE, EXPERT_SLICE, PIPELINE_SLICE = (
    tfm.COMPOSE_SLICE, tfm.EXPERT_SLICE, tfm.PIPELINE_SLICE)
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
    **{n: (1, PIPELINE_SLICE) for n in ("pp", "interleave")},
    "ep": (1, EXPERT_SLICE),
    **{n: (None, PLANNING_SLICE) for n in ("sync_plan", "sync_route")},
    "pp_size": (0, PIPELINE_SLICE),
    "microbatches": (0, PIPELINE_SLICE),
}


def model_parallel(cfg: LMTrainConfig) -> bool:
    """Whether the config cuts the model (tensor parallel) or the sequence
    (sequence parallel): the ``("data", "expert", "seq", "model")`` mesh."""
    return cfg.tp > 1 or cfg.sp > 1


def n_ranks(cfg: LMTrainConfig) -> int:
    """The ranks (one process and one device each) the config spans."""
    return cfg.dp * cfg.ep * cfg.sp * cfg.tp


def _refuse_model_parallel_compositions(cfg: LMTrainConfig) -> None:
    """The knobs that compose with tp / sp in the JAX package and are left
    to ROADMAP slice 5d-i-b, and MoE under a tensor axis (5d-iii)."""
    if not model_parallel(cfg):
        return
    knobs = [what for on, what in (
        (cfg.fsdp, "fsdp=True"),
        (cfg.dcn_size > 1, f"dcn_size={cfg.dcn_size}"),
        (cfg.overlap, "overlap=True"),
        (cfg.sync_every > 1, f"sync_every={cfg.sync_every}"),
        (cfg.staleness != 0, f"staleness={cfg.staleness}"),
        (cfg.outer_opt is not None, f"outer_opt={cfg.outer_opt!r}")) if on]
    if knobs:
        raise tfm.not_ported(
            f"LMTrainConfig {', '.join(knobs)} with tp={cfg.tp}, "
            f"sp={cfg.sp}", COMPOSE_SLICE)
    if cfg.tp > 1 and cfg.model.n_experts:
        raise tfm.not_ported(f"an MoE model (n_experts="
                             f"{cfg.model.n_experts}) with tp={cfg.tp}",
                             EXPERT_SLICE)


def validate_lm_cfg(cfg: LMTrainConfig) -> None:
    """The JAX package's value checks for the data axis and one device,
    then a ``NotImplementedError`` for any knob of a later slice."""
    if cfg.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {cfg.grad_accum}")
    if cfg.dp < 1:
        raise ValueError(f"dp must be >= 1, got {cfg.dp}")
    pipelined = cfg.pp > 1 or cfg.pp_size > 0
    if cfg.dcn_size < 1:
        raise ValueError(f"dcn_size must be >= 1, got {cfg.dcn_size}")
    if cfg.dcn_size > 1:
        if cfg.dp % cfg.dcn_size:
            raise ValueError(f"dp={cfg.dp} does not factor into "
                             f"dcn_size={cfg.dcn_size} slices")
        if cfg.pp > 1:
            raise ValueError("dcn_size does not compose with pp (the "
                             "pipeline mesh has no factored data axis)")
    if cfg.bucket_mb is not None and cfg.bucket_mb <= 0:
        raise ValueError(f"bucket_mb must be > 0, got {cfg.bucket_mb}")
    if cfg.dcn_compress is not None:
        if cfg.dcn_compress not in ("int8", "int4"):
            raise ValueError(
                f"dcn_compress must be None, 'int8', or 'int4', got "
                f"{cfg.dcn_compress!r}")
        if cfg.dcn_size < 2:
            raise ValueError(
                f"dcn_compress={cfg.dcn_compress!r} quantizes the "
                "cross-slice (dcn) hop of the factored-mesh sync; with "
                f"dcn_size={cfg.dcn_size} there is no DCN hop to compress")
        if pipelined:
            raise ValueError(
                "dcn_compress does not compose with pipeline parallelism "
                "(pp/pp_size): the pipeline gradient paths are "
                "hand-emitted without the stateful sync-state channel "
                "(open item); drop the pipeline or the compression")
    if (cfg.sync_every != 1 or cfg.staleness != 0
            or cfg.max_sync_every != 1 or cfg.outer_opt is not None
            or cfg.sync_every_per_slice is not None):
        strat.require_sync_window(
            sync_every=cfg.sync_every, staleness=cfg.staleness,
            max_sync_every=cfg.max_sync_every, mesh=True,
            overlap=cfg.overlap, pp=pipelined,
            grad_accum=cfg.grad_accum, dcn_size=cfg.dcn_size,
            trainer="lm", outer_opt=cfg.outer_opt,
            outer_momentum=cfg.outer_momentum, outer_lr=cfg.outer_lr,
            sync_every_per_slice=cfg.sync_every_per_slice)
    if cfg.fsdp_gather_dtype is not None:
        if cfg.fsdp_gather_dtype not in ("int8", "int4"):
            raise ValueError(
                f"fsdp_gather_dtype must be None, 'int8' or 'int4', got "
                f"{cfg.fsdp_gather_dtype!r}")
        if not cfg.fsdp:
            raise ValueError(
                "fsdp_gather_dtype quantizes the ZeRO-3 weight "
                "all-gather; with fsdp=False there is no gather to "
                "quantize")
        if cfg.pp_size > 0:
            raise ValueError(
                "fsdp_gather_dtype does not compose with pp_size: the "
                "1F1B stacked per-chunk gather is a separate path kept "
                "full-precision (open item); drop one")
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
    if (cfg.loss_impl == "chunked" and cfg.tp > 1 and not pipelined
            and cfg.model.vocab_size % cfg.tp):
        raise ValueError(
            f"vocab_size {cfg.model.vocab_size} must divide over "
            f"tp={cfg.tp} for the chunked (vocab-sharded) head")
    if cfg.loss_chunk is not None:
        if cfg.loss_impl != "chunked":
            raise ValueError(
                f"loss_chunk={cfg.loss_chunk} only applies to "
                "loss_impl='chunked'; the dense head has no chunk size "
                "(set loss_impl='chunked' or drop loss_chunk)")
        v = cfg.model.vocab_size
        # the streamed head shards the vocabulary over 'model'
        v_local = v // cfg.tp if (cfg.tp > 1 and not pipelined) else v
        if cfg.loss_chunk <= 0 or v_local % cfg.loss_chunk:
            raise ValueError(
                f"loss_chunk={cfg.loss_chunk} must be a positive divisor "
                f"of the per-rank vocab rows ({v_local}"
                + (f" = {v} // tp={cfg.tp}" if v_local != v else "")
                + ") — the streaming scan needs equal-sized chunks")
    if cfg.remat not in ("none", "full", "selective"):
        raise ValueError(f"remat must be 'none', 'full' or 'selective', got "
                         f"{cfg.remat!r}")
    if cfg.remat != "none" and pipelined:
        raise ValueError(
            "remat does not compose with pipeline parallelism (pp/pp_size): "
            "the pipeline schedulers own their own rematerialization; drop "
            "one")
    if cfg.fsdp and cfg.dp // max(cfg.dcn_size, 1) == 1:
        # the ZeRO-3 leaves shard over the slice-local data axis: at size 1
        # fsdp would silently keep every parameter whole
        raise ValueError(
            f"fsdp=True with dp={cfg.dp}, dcn_size={cfg.dcn_size} is a "
            f"no-op: the slice-local data axis has size "
            f"dp // dcn_size = 1, so no leaf can shard over it — raise "
            f"dp (or drop fsdp)")
    if cfg.overlap:
        # under grad_accum > 1 the dcn exchange runs once after the
        # microbatches, outside the backward: only fsdp streams there
        strat.require_lm_overlap_streamable(
            fsdp=cfg.fsdp,
            dcn=cfg.dcn_size > 1 and (cfg.grad_accum == 1
                                      or cfg.pp_size > 0),
            pp=cfg.pp_size > 0)
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
    if not pipelined and cfg.tp > 1:
        if m.n_heads % cfg.tp:
            raise ValueError(f"n_heads {m.n_heads} must divide over "
                             f"tp={cfg.tp}")
        if m.kv_heads % cfg.tp:
            raise ValueError(
                f"n_kv_heads {m.kv_heads} must divide over "
                f"tp={cfg.tp} (replicating kv heads across tensor ranks is "
                f"not supported; lower tp or raise n_kv_heads)")
    if cfg.seq_layout not in ("contiguous", "zigzag"):
        raise ValueError(f"layout must be 'contiguous' or 'zigzag', "
                         f"got {cfg.seq_layout!r}")
    for name, (off, where) in _LATER.items():
        value = getattr(cfg, name)
        if value != off:
            raise tfm.not_ported(f"LMTrainConfig.{name}={value!r}", where)
    _refuse_model_parallel_compositions(cfg)


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
               grad_sq_sum: torch.Tensor, target: dict | None = None
               ) -> None:
        """``target`` (a sync window's delta) takes the update in place
        of ``params``, which the weight decay reads."""
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
        torch._foreach_add_(p if target is None else
                            [target[n] for n in names], upd)
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


def _model_kw(cfg: LMTrainConfig, place, tokens) -> tuple:
    """``apply``'s and ``head_loss``'s tensor / sequence parallel keywords
    for this rank (none outside such a run)."""
    if place is None:
        return {}, {}
    return (dict(seq_axis=place.seq_axis, seq_layout=cfg.seq_layout,
                 tp_axis=place.tp_axis,
                 pos=place.positions(tokens.shape[1], tokens.device)),
            dict(tp_axis=place.tp_axis, tp_size=cfg.tp))


def _loss_fn(cfg: LMTrainConfig, attn_impl: str, params, tokens, targets,
             n_total, aux_w, n_ranks: int = 1, boundary=None, place=None):
    """This rank's share of the step's loss: ``ce_sum / n_total`` (the
    GLOBAL count) plus ``aux_w`` times this rank's aux over ``n_ranks``
    (the JAX ``pmean`` of the aux over the data (and seq) axes, taken by
    the sum over ranks).  ``boundary`` is the streaming hook
    (``overlap``); ``place`` the rank's ``LMPlace`` under tp / sp, whose
    ``tokens`` are its sequence chunk."""
    apply_kw, head_kw = _model_kw(cfg, place, tokens)
    head = partial(losses.head_loss, targets=targets,
                   loss_impl=cfg.loss_impl, loss_chunk=cfg.loss_chunk,
                   **head_kw)
    (ce_sum, _), aux = tfm.apply(params, tokens, cfg=cfg.model,
                                 dtype=cfg.dtype, attn_impl=attn_impl,
                                 return_aux=True, head_fn=head,
                                 matmul_dtype=cfg.matmul_dtype,
                                 remat=cfg.remat, boundary=boundary,
                                 **apply_kw)
    return ce_sum / n_total.clamp_min(1) + aux_w * (aux * (1.0 / n_ranks))


# -- the sync knobs: ZeRO-3, the two-level dcn sync, overlap ------------------

DCN, DATA = "dcn", DATA_AXIS
EXPERT, SEQ = "expert", "seq"
MODEL = tfm.MODEL_AXIS  # the JAX tensor axis (size 1 without tp)


def jax_path(name: str) -> tuple[str, ...]:
    """A port name's path in the JAX param tree: ``layers.3.moe.router`` ->
    ``("layer3", "moe", "router")``."""
    parts = name.split(".")
    if parts[0] == "layers":
        return (f"layer{parts[1]}",) + tuple(parts[2:])
    return tuple(parts)


def jax_order(names) -> list[str]:
    """``names`` in the JAX package's tree order (dict keys sorted at every
    level: ``embed, final_norm, layer0, layer1, layer10, ...``)."""
    return sorted(names, key=jax_path)


param_shapes = tfm.init_shapes  # every parameter's shape, unbuilt


def param_specs(cfg: LMTrainConfig, shapes: dict | None = None
                ) -> dict[str, tuple]:
    """Each leaf's partition spec as the JAX ``param_specs`` gives it, a
    tuple of axis names (or None) a dim: the Megatron layout over the
    size-1 ``model`` axis, and with ``fsdp`` the ZeRO-3 dim, the first
    dim that is not on another axis and that the slice-local data size
    divides (``data``); a leaf with none stays replicated."""
    shapes = shapes or param_shapes(cfg.model)
    inner = cfg.dp // cfg.dcn_size
    base_specs = tfm.shard_specs(cfg.model, shapes)
    out = {}
    for name, shape in shapes.items():
        base = base_specs[name]
        spec = list(base) + [None] * (len(shape) - len(base))
        if cfg.fsdp and inner > 1:
            for i, dim in enumerate(shape):
                if spec[i] is None and dim % inner == 0:
                    spec[i] = DATA
                    break
        out[name] = tuple(spec)
    return out


def fsdp_dim(spec: tuple) -> int | None:
    """The dim a leaf is sharded along over ``data`` (None: replicated)."""
    return spec.index(DATA) if DATA in spec else None


def make_lm_mesh(cfg: LMTrainConfig, device: str | torch.device = "cuda"):
    """The mesh over the default process group: ``("data",)`` of ``dp``
    ranks, ``("dcn", "data")`` of ``(dcn_size, dp // dcn_size)`` with
    ``dcn_size > 1`` (the slices outermost), or with ``tp > 1`` or
    ``sp > 1`` ``("data", "expert", "seq", "model")`` of ``(dp, ep, sp,
    tp)``, ``model`` innermost as the JAX mesh lays devices, so that rank r
    sits at JAX device r's coordinates."""
    validate_lm_cfg(cfg)
    one_process_per_device(n_ranks(cfg))
    if model_parallel(cfg):
        return make_mesh(n_ranks(cfg), axis_names=(DATA, EXPERT, SEQ, MODEL),
                         axis_shape=(cfg.dp, cfg.ep, cfg.sp, cfg.tp),
                         device=device)
    if cfg.dcn_size > 1:
        return make_mesh(cfg.dp, axis_names=(DCN, DATA),
                         axis_shape=(cfg.dcn_size, cfg.dp // cfg.dcn_size),
                         device=device)
    return make_mesh(cfg.dp, device=device)


class LMPlace:
    """One rank's place in the ``("data", "expert", "seq", "model")`` mesh
    of a tensor / sequence parallel run: its coordinates, the ``seq`` group
    (the ring), the ``model`` group (the Megatron sums and the tp head),
    and ``batch``, the data x expert x seq group of its model index, over
    which the token count, the loss and the gradients are summed (the JAX
    reduction over ``_batch_axes + ("seq",)``).  Each leaf's ``tp_dims``
    entry is the dim it splits along over ``model`` (None: replicated)."""

    def __init__(self, cfg: LMTrainConfig, mesh):
        names = tuple(mesh.mesh_dim_names or ())
        if names != (DATA, EXPERT, SEQ, MODEL):
            raise ValueError(
                f"tp={cfg.tp}, sp={cfg.sp} needs a ('data', 'expert', "
                f"'seq', 'model') mesh (make_lm_mesh), got axes {names}")
        self.cfg = cfg
        (self.data_index, self.expert_index, self.seq_index,
         self.model_index) = mesh.get_coordinate()
        self.seq = mesh.get_group(SEQ)
        self.model = mesh.get_group(MODEL)
        ranks = mesh.mesh
        self.batch = None
        for m in range(cfg.tp):  # every rank makes every group, in order
            members = sorted(int(r) for r in ranks[..., m].flatten())
            group = dist.new_group(members)
            if m == self.model_index:
                self.batch = group
        self.n_batch = dist.get_world_size(self.batch)
        self.tp_dims = {n: (tfm.tp_dim(sp) if cfg.tp > 1 else None)
                        for n, sp in tfm.shard_specs(cfg.model).items()}

    @classmethod
    def of(cls, cfg: LMTrainConfig, mesh):
        """The mesh's place (made once a mesh: its groups are collective
        to make), or None outside a tensor / sequence parallel run."""
        if mesh is None or not model_parallel(cfg):
            return None
        place = getattr(mesh, "_lm_place", None)
        if place is None:
            place = mesh._lm_place = cls(cfg, mesh)
        return place

    @property
    def seq_axis(self):
        return self.seq if self.cfg.sp > 1 else None

    @property
    def tp_axis(self):
        return self.model if self.cfg.tp > 1 else None

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's tp shard of a whole leaf (the leaf if replicated)."""
        dim = self.tp_dims[name]
        if dim is None:
            return full
        m = full.shape[dim] // self.cfg.tp
        return full.narrow(dim, self.model_index * m, m)

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of this rank's shard (every rank of ``model``
        must call it)."""
        dim = self.tp_dims[name]
        return t if dim is None else _gather_dim(t, dim, self.model)

    def seq_chunk(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of its data rank's rows (B, S): the zigzag
        permutation of the sequence (the JAX ``_zigzag_global``), then the
        contiguous ``seq_index``-th of ``sp`` slices."""
        cfg = self.cfg
        if cfg.sp == 1:
            return x
        s = x.shape[1]
        if cfg.seq_layout == "zigzag":
            perm = pctx.zigzag_permutation(cfg.sp, s)
            x = x[:, torch.as_tensor(perm, device=x.device)]
        if s % cfg.sp:
            raise ValueError(f"sequence length {s} does not split over "
                             f"sp={cfg.sp}")
        c = s // cfg.sp
        return x[:, self.seq_index * c:(self.seq_index + 1) * c]

    def positions(self, s_local: int, device) -> torch.Tensor:
        """The chunk's global positions (the JAX ``_shard_positions``)."""
        cfg = self.cfg
        if cfg.sp > 1 and cfg.seq_layout == "zigzag":
            return pctx.zigzag_positions(self.seq_index, cfg.sp, s_local,
                                         device=device)
        return self.seq_index * s_local + torch.arange(s_local,
                                                       device=device)

    def global_sq(self, names: list[str], tensors: list) -> torch.Tensor:
        """The sum of squares of the whole leaves from this rank's shards:
        each tp-sharded leaf's summed over ``model``, each replicated leaf
        counted once."""
        sq = torch.stack(torch._foreach_norm(tensors)).float().square()
        idx = [i for i, n in enumerate(names)
               if self.tp_dims[n] is not None]
        if idx:
            part = sq[idx]
            dist.all_reduce(part, group=self.model)
            sq[idx] = part
        return sq.sum()


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The tiled all-gather of ``x`` along ``dim`` over ``group``."""
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    strat.all_gather_flat(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def _scatter_dim(ct: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The reduce-scatter (sum) of ``ct`` along ``dim`` over ``group``: the
    tiled gather's transpose."""
    n = dist.get_world_size(group)
    cm = ct.movedim(dim, 0).contiguous()
    out = torch.empty((cm.shape[0] // n,) + tuple(cm.shape[1:]),
                      dtype=ct.dtype, device=ct.device)
    strat.reduce_scatter_flat(out, cm, group=group)
    return out.movedim(0, dim).contiguous()


def quantize_rows(x: torch.Tensor, dim: int, bits: int):
    """The fsdp gather's codec: ``x`` quantized to int8 levels (+/-127, or
    +/-7 at ``bits=4``) against one float32 scale a row, a row being an
    index along ``dim`` (the scales gather along the payload's dim): the
    JAX ``_q8_shard_gather`` / ``_q4_shard_gather`` arithmetic."""
    levels = 127.0 if bits == 8 else 7.0
    x32 = x.float()
    axes = tuple(i for i in range(x.ndim) if i != dim)
    absmax = x32.abs().amax(dim=axes, keepdim=True) if axes else x32.abs()
    scale = torch.clamp_min(absmax * (1.0 / levels), 1e-30)
    q = torch.clamp(torch.round(x32 / scale), -levels, levels) \
        .to(torch.int8)
    return q, scale


def pack_rows(q: torch.Tensor, dim: int) -> torch.Tensor:
    """int4 values (int8 in [-7, 7]) two a byte along ``dim`` (odd lengths
    padded by one), biased by 8, the even index in the low nibble."""
    if q.shape[dim] % 2:
        q = torch.cat([q, torch.zeros_like(q.narrow(dim, 0, 1))], dim)
    pairs = q.unflatten(dim, (-1, 2))
    lo, hi = pairs.select(dim + 1, 0), pairs.select(dim + 1, 1)
    return (lo + 8).to(torch.uint8) | ((hi + 8).to(torch.uint8) << 4)


def unpack_rows(p: torch.Tensor, dim: int, m: int) -> torch.Tensor:
    """``pack_rows``'s inverse: int8 values, ``m`` long along ``dim``."""
    lo = (p & 0xF).to(torch.int8) - 8
    hi = ((p >> 4) & 0xF).to(torch.int8) - 8
    u = torch.stack([lo, hi], dim=dim + 1).flatten(dim, dim + 1)
    return u.narrow(dim, 0, m)


def _gather_codec(x: torch.Tensor, dim: int, group,
                  dtype: str | None) -> torch.Tensor:
    """One fsdp leaf's all-gather along ``dim``: plain, or with
    ``dtype="int8"``/``"int4"`` the local shard quantized against per-row
    scales, payload and scales gathered, and dequantized."""
    if dtype is None:
        return _gather_dim(x, dim, group)
    q, scale = quantize_rows(x, dim, 8 if dtype == "int8" else 4)
    sg = _gather_dim(scale, dim, group)
    if dtype == "int8":
        qg = _gather_dim(q, dim, group)
    else:
        n = dist.get_world_size(group)
        packed = pack_rows(q, dim)
        flat = torch.empty(n * packed.numel(), dtype=packed.dtype,
                           device=packed.device)
        strat.all_gather_flat(flat, packed.reshape(-1), group=group)
        parts = flat.view((n,) + tuple(packed.shape)).unbind(0)
        qg = torch.cat([unpack_rows(pt, dim, x.shape[dim]) for pt in parts],
                       dim)
    return (qg.float() * sg).to(x.dtype)


class _FsdpGather(torch.autograd.Function):
    """A ZeRO-3 leaf's gather; its backward is the plain reduce-scatter
    (a straight-through estimator for the quantized gathers: the gradient
    stream is never quantized), the transpose JAX's autodiff gives."""

    @staticmethod
    def forward(ctx, shard, dim, group, dtype):
        ctx.dim, ctx.group = dim, group
        return _gather_codec(shard, dim, group, dtype)

    @staticmethod
    def backward(ctx, ct):
        return _scatter_dim(ct, ctx.dim, ctx.group), None, None, None


def _sync_bucket_bytes(cfg: LMTrainConfig) -> int:
    """The two-level sync's bucket size: ``bucket_mb``, or 25 MB."""
    mb = cfg.bucket_mb if cfg.bucket_mb is not None else strat.BUCKET_CAP_MB
    return int(mb * 1024 * 1024)


def _sync_partition(sizes: list[int], specs: list[tuple],
                    bucket_bytes: int | None) -> list[tuple[str, list[int]]]:
    """The ordered partition the two-level sync walks: the fsdp (``data``-
    sharded) leaves first, then the others grouped by their set of sharded
    axes (first-appearance order), each run cut into ``make_bucket_plan``
    buckets when ``bucket_bytes`` is given: ``[(kind, [leaf index, ...])]``,
    kind ``"fsdp"`` or ``"two_level"``.  The JAX ``_sync_partition``, the
    layout contract with the residual's length."""
    groups: dict = {}
    fsdp_items: list[int] = []
    for i, sp in enumerate(specs):
        axes = frozenset(a for a in sp if a is not None)
        if DATA in axes:
            fsdp_items.append(i)
        else:
            groups.setdefault(axes, []).append(i)

    def buckets(idxs: list[int]) -> list[list[int]]:
        if not idxs:
            return []
        if bucket_bytes is None or len(idxs) <= 1:
            return [idxs]
        plan = strat.make_bucket_plan(
            [strat.SizedLeaf(sizes[i], np.float32) for i in idxs],
            bucket_bytes)
        return [[idxs[j] for j in b] for b in plan]

    return ([("fsdp", b) for b in buckets(fsdp_items)]
            + [("two_level", b) for items in groups.values()
               for b in buckets(items)])


def _bucket_residual_len(kind: str, total: int, n_dcn: int,
                         n_ici: int) -> int:
    """One bucket's residual: n_dcn x the ring chunk of what crosses dcn
    (the whole fsdp bucket, already shard-sized; else the ``data`` shard)."""
    base = total if kind == "fsdp" else -(-total // n_ici)
    return n_dcn * strat.QuantizedRing()._chunk(base, n_dcn)


def _residual_total_len(sizes: list[int], specs: list[tuple], n_dcn: int,
                        n_ici: int, bucket_bytes: int | None) -> int:
    return sum(_bucket_residual_len(kind, sum(sizes[i] for i in idxs),
                                    n_dcn, n_ici)
               for kind, idxs in _sync_partition(sizes, specs,
                                                 bucket_bytes))


def _local_sizes(cfg: LMTrainConfig, names: list[str], specs: dict,
                 shapes: dict) -> list[int]:
    """Each leaf's size on one rank: a ZeRO-3 leaf's shard."""
    inner = cfg.dp // cfg.dcn_size
    return [int(np.prod(shapes[n], dtype=np.int64))
            // (inner if fsdp_dim(specs[n]) is not None else 1)
            for n in names]


def sharded(cfg: LMTrainConfig) -> bool:
    """Whether the step is the sharded one (ZeRO-3 or the two-level sync)
    rather than the flat all-reduce."""
    return cfg.fsdp or cfg.dcn_size > 1


def _streamed(cfg: LMTrainConfig) -> bool:
    """Whether the dcn sync points stream per layer group (never under
    sync windows: the compressed exchange runs at the window boundary,
    over the whole tree)."""
    return (cfg.overlap and cfg.dcn_size > 1 and cfg.grad_accum == 1
            and cfg.sync_every == 1)


def lm_sync_state_len(cfg: LMTrainConfig) -> int:
    """One rank's residual length under ``dcn_compress``: the whole tree's
    partition (the post-backward and accumulation paths), or each layer
    group's in group order when the sync points stream (``overlap``)."""
    if cfg.dcn_compress is None or cfg.dcn_size < 2:
        return 0
    n_dcn, n_ici = cfg.dcn_size, cfg.dp // cfg.dcn_size
    bucket_bytes = _sync_bucket_bytes(cfg)
    shapes = param_shapes(cfg.model)
    specs = param_specs(cfg, shapes)
    names = jax_order(shapes)
    runs = [names]
    if _streamed(cfg):
        runs = [tfm.group_params(names, k) for k, _ in sorted(
            tfm.sync_group_index(cfg.model).items(), key=lambda kv: kv[1])]
    return sum(_residual_total_len(_local_sizes(cfg, run, specs, shapes),
                                   [specs[n] for n in run], n_dcn, n_ici,
                                   bucket_bytes) for run in runs)


def _lm_window_wire_bytes(cfg: LMTrainConfig) -> int:
    """One rank's float32 payload of one window-boundary exchange over
    ``dcn`` (the JAX ``_lm_window_wire_bytes``), for the
    ``window_wire_bytes`` gauge: the whole tree's sync partition, a ZeRO-3
    bucket crossing at its shard's size, any other at its ``data`` shard
    of the bucket."""
    n_data = cfg.dp // cfg.dcn_size
    shapes = param_shapes(cfg.model)
    specs = param_specs(cfg, shapes)
    names = jax_order(shapes)
    sizes = _local_sizes(cfg, names, specs, shapes)
    total = 0
    for kind, idxs in _sync_partition(sizes, [specs[n] for n in names],
                                      _sync_bucket_bytes(cfg)):
        elems = sum(sizes[i] for i in idxs)
        total += 4 * (elems if kind == "fsdp" else -(-elems // n_data))
    return total


class LMSync:
    """One rank's view of the sharded data-parallel step: the mesh's groups,
    each leaf's spec and ZeRO-3 dim, this rank's ``data`` index, and the
    gathers and the two-level sync over them."""

    def __init__(self, cfg: LMTrainConfig, mesh, shapes: dict):
        self.cfg = cfg
        self.specs = param_specs(cfg, shapes)
        self.dims = {n: fsdp_dim(sp) for n, sp in self.specs.items()}
        self.names = jax_order(shapes)
        if cfg.dcn_size > 1:
            if tuple(mesh.mesh_dim_names or ()) != (DCN, DATA):
                raise ValueError(
                    f"dcn_size={cfg.dcn_size} needs a ('dcn', 'data') mesh "
                    f"(make_lm_mesh), got axes {mesh.mesh_dim_names}")
            self.dcn, self.data = mesh.get_group(DCN), mesh.get_group(DATA)
        else:
            self.dcn, self.data = None, mesh.get_group()
        self.world = mesh_group(mesh)
        self.n_dcn = cfg.dcn_size
        self.n_data = dist.get_world_size(self.data)
        self.data_rank = dist.get_rank(self.data)
        self.bucket_bytes = _sync_bucket_bytes(cfg)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-3 shard of a whole leaf (the leaf if
        replicated)."""
        dim = self.dims[name]
        if dim is None:
            return full
        m = full.shape[dim] // self.n_data
        return full.narrow(dim, self.data_rank * m, m)

    def gather_all(self, params: dict, dtype: str | None = None) -> dict:
        """Every leaf whole: the ZeRO-3 leaves through ``_FsdpGather``."""
        return {n: p if self.dims[n] is None else
                _FsdpGather.apply(p, self.dims[n], self.data, dtype)
                for n, p in params.items()}

    def two_level(self, grads: list, names: list[str],
                  bucket_bytes: int | None = None,
                  compress: str | None = None,
                  residual: torch.Tensor | None = None):
        """The JAX ``_two_level_sync`` of ``grads`` (this rank's, of the
        leaves ``names`` in JAX order): per ``_sync_partition`` bucket, a
        ZeRO-3 bucket (already the ``data`` shard's sum) summed over
        ``dcn``, any other through ``two_level_psum``; with ``compress`` the
        dcn exchange is the quantized ring, the residual's segments taken
        and refilled in partition order.  Returns ``(sums, new
        residual)``; the sums are over every rank (no mean)."""
        specs = [self.specs[n] for n in names]
        sizes = [g.numel() for g in grads]
        parts = _sync_partition(sizes, specs, bucket_bytes)
        ring = strat.QuantizedRing(bits=4 if compress == "int4" else 8)

        def sync_fn(j, vals, res):
            kind = parts[j][0]
            if compress is None:
                return (flat_all_reduce(vals, self.dcn) if kind == "fsdp"
                        else strat.two_level_psum(vals, self.dcn,
                                                  self.data)), res
            out: dict = {}
            reduce = strat.ring_reduce(ring, self.dcn, self.n_dcn, res, out)
            if kind == "fsdp":  # the bucket is already shard-sized
                synced = strat._split(reduce(strat._flat(vals,
                                                         torch.float32)),
                                      vals)
            else:
                synced = strat.two_level_psum(vals, self.dcn, self.data,
                                              dcn_reduce=reduce)
            return synced, out["res"]

        segs = [_bucket_residual_len(kind, sum(sizes[i] for i in idxs),
                                     self.n_dcn, self.n_data)
                if compress is not None else 0 for kind, idxs in parts]
        if compress is None:
            residual = torch.zeros(0, dtype=torch.float32,
                                   device=grads[0].device)
        return strat.sync_segments(grads, [idxs for _, idxs in parts], segs,
                                   sync_fn, residual)

    def stream_boundary(self, params: dict, *, dcn_sync: bool,
                        inflight, residual: torch.Tensor | None = None,
                        new_res: dict | None = None,
                        local_sync: bool = False):
        """The ``overlap`` hook for ``transformer.apply``: at each layer
        group's boundary the group's ZeRO-3 leaves are gathered, and in the
        backward, right after the group's own backward, their gradients are
        reduce-scattered and (``dcn_sync``) the group's two-level sync runs,
        in the JAX order (gather's transpose, then the sync point's dcn
        exchange), issued through ``inflight`` (a side stream on the card;
        ``.grad`` is written when the backward ends).  With compression
        each group takes its residual segment in group order; the new ones
        land in ``new_res`` by group.  ``local_sync`` (a window's local
        step) syncs within the slice instead (``local_sync``)."""
        cfg = self.cfg
        keys = {v: k for k, v in tfm.sync_group_index(cfg.model).items()}
        compress = cfg.dcn_compress if dcn_sync else None
        state = {"off": 0}

        def boundary(group: int, p: dict) -> dict:
            key = keys.get(group)
            if key is None:
                return p
            names = tfm.group_params(self.names, key)
            leaves = [params[n] for n in names]
            dims = [self.dims[n] for n in names]
            # the leaves whose gradients the point delivers itself; a
            # replicated leaf without the dcn sync goes back to autograd
            mine = [i for i, d in enumerate(dims)
                    if dcn_sync or local_sync or d is not None]
            res = None
            if compress is not None:
                seg = _residual_total_len(
                    [t.numel() for t in leaves],
                    [self.specs[n] for n in names], self.n_dcn,
                    self.n_data, self.bucket_bytes)
                a = state["off"]
                state["off"] = a + seg
                res = residual[a:a + seg]

            def forward_fn(ts):
                return [t.view_as(t) if d is None else
                        _gather_codec(t, d, self.data, cfg.fsdp_gather_dtype)
                        for t, d in zip(ts, dims)]

            def sync_fn(cts):
                shards = [ct if dims[i] is None else
                          _scatter_dim(ct, dims[i], self.data)
                          for i, ct in zip(mine, cts)]
                if local_sync:
                    return self.local_sync(shards, [dims[i] for i in mine])
                if not dcn_sync:
                    return shards
                synced, new = self.two_level(
                    shards, names, self.bucket_bytes if compress else None,
                    compress, res)
                if compress is not None:
                    new_res[group] = new
                return synced

            def backward_fn(cts):
                if mine:
                    inflight.launch(sync_fn, [cts[i] for i in mine],
                                    [leaves[i] for i in mine])
                grads = list(cts)
                for i in mine:
                    grads[i] = None
                return grads

            out = dict(p)
            marked = strat._SyncPoint.apply(f"stream_boundary:{group}",
                                            forward_fn, backward_fn, *leaves)
            out.update(zip(names, marked))
            return out

        return boundary

    def local_sync(self, grads: list, dims: list) -> list:
        """A window's local-step gradient sync (the JAX
        ``_local_sync_point``, without the reference's extra factor): the
        replicated leaves summed over the slice's ``data`` ranks in one
        flat all-reduce (the ZeRO-3 leaves come reduce-scattered), then
        every leaf times ``n_dcn``: each slice's gradient of its own
        tokens at the full-batch rate.  No byte crosses ``dcn``."""
        rep = [i for i, d in enumerate(dims) if d is None]
        out = list(grads)
        if rep:
            for i, t in zip(rep, flat_all_reduce([grads[i] for i in rep],
                                                 self.data)):
                out[i] = t
        torch._foreach_mul_(out, float(self.n_dcn))
        return out

    def global_sq(self, tensors: list) -> torch.Tensor:
        """The sum of squares of the whole leaves from this rank's (in
        ``self.names`` order): each ZeRO-3 leaf's shard sums added over
        ``data``, each replicated leaf counted once."""
        sq = torch.stack(torch._foreach_norm(tensors)).float().square()
        idx = [i for i, n in enumerate(self.names)
               if self.dims[n] is not None]
        if idx:
            part = sq[idx]
            dist.all_reduce(part, group=self.data)
            sq[idx] = part
        return sq.sum()


def _make_sharded_step(cfg: LMTrainConfig, attn_impl: str, mesh, update,
                       loss_fn):
    """The step of ``fsdp`` and ``dcn_size > 1`` (the JAX
    ``_make_grad_step`` / ``_make_accum_grad_step`` paths):
    ``step(params, opt_state, tokens, targets, sync_state) -> (loss, ok,
    met, sync_state)`` over this rank's shards."""
    sync = LMSync(cfg, mesh, param_shapes(cfg.model))
    a = cfg.grad_accum
    dcn = cfg.dcn_size > 1
    compress = cfg.dcn_compress if dcn else None
    stream_dcn = _streamed(cfg)

    def step(params, opt_state, tokens, targets, sync_state=None,
             step_no=0, fault_arm=0.0):
        names = sync.names
        for p in params.values():
            p.grad = None
        n_total = (targets != IGNORE).sum().float()
        dist.all_reduce(n_total, group=sync.world)
        inflight = strat._InFlight()
        new_res: dict = {}
        loss = torch.zeros((), device=tokens.device)
        micro = zip(_micro_split(tokens, a), _micro_split(targets, a)) \
            if a > 1 else [(tokens, targets)]
        for tk, tg in micro:
            if cfg.overlap:
                boundary = sync.stream_boundary(
                    params, dcn_sync=stream_dcn, inflight=inflight,
                    residual=sync_state, new_res=new_res)
                loss_i = loss_fn(params, tk, tg, n_total, cfg.aux_coef / a,
                                 boundary=boundary)
            else:
                loss_i = loss_fn(sync.gather_all(params,
                                                 cfg.fsdp_gather_dtype),
                                 tk, tg, n_total, cfg.aux_coef / a)
            loss_i.backward()
            loss = loss + loss_i.detach() if a > 1 else loss_i.detach()
        grads = [params[n].grad for n in names]
        if fault_arm:  # the fault taps, before the sync (JAX tree order)
            grads = faults.tap_grads(grads, step_no, fault_arm)
            loss = faults.tap_loss(loss, step_no, fault_arm)
        if dcn and not stream_dcn:
            # the whole tree after the backward (or the microbatches): JAX
            # buckets here only for the accumulation path and compression
            bb = sync.bucket_bytes if (a > 1 or compress) else None
            grads, sync_state = sync.two_level(grads, names, bb, compress,
                                               sync_state)
        elif stream_dcn and compress is not None:
            sync_state = torch.cat([new_res[g] for g in sorted(new_res)])
        elif not dcn:  # the replicated leaves: one flat sum over data
            rep = [i for i, n in enumerate(names) if sync.dims[n] is None]
            if rep:
                summed = flat_all_reduce([grads[i] for i in rep], sync.data)
                for i, s in zip(rep, summed):
                    grads[i] = s
        dist.all_reduce(loss, group=sync.world)
        gsq = sync.global_sq(grads)
        ok = (torch.isfinite(loss) & torch.isfinite(gsq)).float()
        update(params, dict(zip(names, grads)), opt_state, gsq)
        for p in params.values():
            p.grad = None
        with torch.no_grad():
            psq = sync.global_sq([params[n] for n in names])
        met = torch.stack([gsq.sqrt(), psq.sqrt()])
        return loss, ok, met, sync_state

    return step


def window_prescales(n_dcn: int, n_data: int, dims: list) -> list[float]:
    """The JAX ``_prescale`` of each leaf's window delta: one over ``n_dcn``
    times ``n_data`` for a leaf not sharded over ``data`` (``dims[i]``
    None: the slice's ``n_data`` ranks all add their copy to the sum), one
    over ``n_dcn`` for a ZeRO-3 leaf, so that the two-level sum is the
    slices' mean."""
    return [1.0 / (n_dcn * (1 if d is not None else n_data)) for d in dims]


def window_prescale(deltas: list, scales: list,
                    keep: float | None = None) -> list:
    """The boundary's arithmetic before the exchange, new tensors: each
    delta times this slice's entry of the per-slice mask ``keep`` (1.0 or
    0.0; None without ``sync_every_per_slice``), then times its
    prescale."""
    if keep is not None:
        deltas = [x * keep for x in deltas]
    return [x * sc for x, sc in zip(deltas, scales)]


class LMWindowSteps:
    """The sync windows' programs (``sync_every = H > 1`` over the
    ``("dcn", "data")`` mesh; the JAX ``make_lm_window_steps``), for one
    rank.  A rank belongs to slice ``rank // n_data`` and holds that
    slice's row of the JAX trainer's ``dcn``-stacked window state: the
    anchor (``LMTrainer.params``, ZeRO-3 shards under ``fsdp``), the delta
    and the Adam state in the params' layout, the residual, and the outer
    momentum in the anchor's layout.  Every program takes and returns
    name-keyed dicts of this rank's tensors.

    - ``local_step``: one optimizer step at ``anchor + delta``, its
      gradient synced within the slice alone (``LMSync.local_sync``:
      ZeRO-3 leaves through their reduce-scatter, replicated leaves
      summed over ``data``, times ``n_dcn``), clipped by the slice's norm,
      the AdamW update added to the delta.  The valid-token count before
      the backward, and the loss with the metrics after it, are scalars
      summed over the world group, the JAX step's scalar ``psum``s; the
      metrics are the JAX step's (the grad-norm over every slice's
      gradient, the param-norm over every slice's ``anchor + delta``).
    - ``exchange``: the delta masked (``sync_every_per_slice``), divided
      by ``n_dcn`` times ``n_data`` for a leaf not sharded over ``data``
      (``_prescale``: the slice's ``n_data`` copies of a replicated delta
      are all summed), through ``LMSync.two_level`` (the residual under
      ``dcn_compress``) to the slices' mean, the anchor moved by it or by
      the outer optimizer, and the delta zeroed (a skipping slice keeps
      its own).
    - ``launch`` / ``apply_pending`` (``staleness > 0``): the same
      exchange, returning the mean and a copy of the delta; ``S`` steps
      later the anchor moves by the mean and the copy is subtracted from
      the live delta."""

    def __init__(self, cfg: LMTrainConfig, mesh, update, loss_fn):
        self.cfg = cfg
        self.sync = LMSync(cfg, mesh, param_shapes(cfg.model))
        self.update = update
        self.loss_fn = loss_fn
        self.outer = strat.OuterOptimizer.of(cfg)
        self.slice = dist.get_rank(self.sync.dcn)
        self.prescales = window_prescales(
            cfg.dcn_size, self.sync.n_data,
            [self.sync.dims[n] for n in self.sync.names])

    def _local_grads(self, local: dict, tokens, targets, step_no=0,
                     fault_arm=0.0) -> torch.Tensor:
        cfg, sync = self.cfg, self.sync
        n_total = (targets != IGNORE).sum().float()
        dist.all_reduce(n_total, group=sync.world)
        if cfg.overlap:
            inflight = strat._InFlight()
            boundary = sync.stream_boundary(local, dcn_sync=False,
                                            inflight=inflight,
                                            local_sync=True)
            loss = self.loss_fn(local, tokens, targets, n_total,
                                cfg.aux_coef, boundary=boundary)
            loss.backward()
            return self._tap(local, loss.detach(), step_no, fault_arm)
        loss = self.loss_fn(sync.gather_all(local, cfg.fsdp_gather_dtype),
                            tokens, targets, n_total, cfg.aux_coef)
        loss.backward()
        loss = self._tap(local, loss.detach(), step_no, fault_arm)
        names = sync.names
        synced = sync.local_sync([local[n].grad for n in names],
                                 [sync.dims[n] for n in names])
        for n, g in zip(names, synced):
            local[n].grad = g
        return loss

    def _tap(self, local: dict, loss, step_no, fault_arm):
        """The fault taps on the local step's gradients (in ``.grad``,
        JAX tree order) and loss: before the local sync, or under
        ``overlap`` after it (it runs inside the backward)."""
        if not fault_arm:
            return loss
        names = self.sync.names
        grads = faults.tap_grads([local[n].grad for n in names], step_no,
                                 fault_arm)
        for n, g in zip(names, grads):
            local[n].grad = g
        return faults.tap_loss(loss, step_no, fault_arm)

    def local_step(self, anchor: dict, delta: dict, opt_state: dict,
                   tokens, targets, step_no=0, fault_arm=0.0):
        """``(loss, ok, met)``; ``delta`` and ``opt_state`` change in
        place.  ``step_no`` and ``fault_arm`` feed the fault taps."""
        sync = self.sync
        names = sync.names
        local = {n: (anchor[n].detach() + delta[n]).requires_grad_(True)
                 for n in names}
        loss = self._local_grads(local, tokens, targets, step_no, fault_arm)
        grads = [local[n].grad for n in names]
        gsq = sync.global_sq(grads)
        self.update(local, dict(zip(names, grads)), opt_state, gsq,
                    target=delta)
        with torch.no_grad():
            psq = sync.global_sq([anchor[n].detach() + delta[n]
                                  for n in names])
            # each slice's norms once: its data rank 0 contributes them
            mine = float(sync.data_rank == 0)
            vec = torch.stack([loss.float(), gsq * mine, psq * mine])
            dist.all_reduce(vec, group=sync.world)
        ok = (torch.isfinite(vec[0]) & torch.isfinite(vec[1])).float()
        return vec[0], ok, vec[1:].sqrt()

    @torch.no_grad()
    def _mean(self, delta: dict, residual: torch.Tensor | None,
              mask: list | None = None):
        """The slices' mean delta and the new residual."""
        cfg, sync = self.cfg, self.sync
        names = sync.names
        # the mask comes before the prescale and the quantization, so the
        # residual keeps the exact error of what was sent
        d = window_prescale([delta[n] for n in names], self.prescales,
                            None if mask is None else mask[self.slice])
        mean, new = sync.two_level(d, names, sync.bucket_bytes,
                                   cfg.dcn_compress, residual)
        return dict(zip(names, mean)), new

    @torch.no_grad()
    def _move(self, anchor: dict, d_avg: dict, m: dict | None):
        """The anchor moved by the mean (in place); the new momentum."""
        names = self.sync.names
        if self.outer is None:
            torch._foreach_add_([anchor[n] for n in names],
                                [d_avg[n] for n in names])
            return m
        new, new_m = self.outer.apply([anchor[n] for n in names],
                                      [d_avg[n] for n in names],
                                      [m[n] for n in names])
        for n, t in zip(names, new):
            anchor[n].copy_(t)
        return dict(zip(names, new_m))

    @torch.no_grad()
    def exchange(self, anchor: dict, delta: dict, residual, m,
                 mask: list | None = None):
        """The boundary: ``(new residual, new momentum)``; the anchor and
        the delta change in place."""
        d_avg, residual = self._mean(delta, residual, mask)
        m = self._move(anchor, d_avg, m)
        if mask is None or mask[self.slice] != 0:
            for x in delta.values():
                x.zero_()
        return residual, m

    @torch.no_grad()
    def launch(self, delta: dict, residual):
        """``(mean, a copy of the delta, new residual)``."""
        d_avg, residual = self._mean(delta, residual)
        return d_avg, {n: x.clone() for n, x in delta.items()}, residual

    @torch.no_grad()
    def apply_pending(self, anchor: dict, delta: dict, d_avg: dict,
                      snap: dict, m):
        """The deferred apply: the new momentum; the anchor and the delta
        change in place."""
        m = self._move(anchor, d_avg, m)
        for n, x in delta.items():
            x.sub_(snap[n])
        return m


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
    after the update).  With ``fsdp`` or ``dcn_size > 1`` the step is
    ``_make_sharded_step``'s, over this rank's shards, and takes and
    returns the residual too.  ``step_no`` and ``fault_arm`` (keywords)
    feed the fault taps (utils/faults.py): on the armed step one gradient
    leaf is poisoned, or the loss scaled, after the backward and before
    the sync.

    Under ``tp`` / ``sp`` (the 4-axis mesh) tokens/targets are the rows of
    this rank's data index, whole sequences; the step cuts its sequence
    chunk (``LMPlace.seq_chunk``), the params are its tp shards, and the
    count, the loss and the gradients are summed over its data x seq group
    (``LMPlace.batch``); the global norm counts each tp shard once."""
    validate_lm_cfg(cfg)
    update = make_optimizer(cfg)
    a = cfg.grad_accum
    place = LMPlace.of(cfg, mesh)
    group = place.batch if place is not None else (
        None if mesh is None else mesh_group(mesh))
    n_ranks = 1 if mesh is None else (
        place.n_batch if place is not None else mesh.size())
    loss_fn = partial(_loss_fn, cfg, attn_impl, n_ranks=n_ranks, place=place)
    if sharded(cfg):
        return _make_sharded_step(cfg, attn_impl, mesh, update, loss_fn)
    order = jax_order(param_shapes(cfg.model))  # the fault taps' leaf order

    def step(params, opt_state, tokens, targets, step_no=0, fault_arm=0.0):
        for p in params.values():
            p.grad = None
        if place is not None:
            tokens, targets = place.seq_chunk(tokens), place.seq_chunk(targets)
        n_total = (targets != IGNORE).sum().float()
        if mesh is not None:  # the global count, before the backward
            dist.all_reduce(n_total, group=group)
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
        if fault_arm:  # the fault taps, before the sync
            grads.update(zip(order, faults.tap_grads(
                [grads[n] for n in order], step_no, fault_arm)))
            loss = faults.tap_loss(loss, step_no, fault_arm)
        if mesh is not None:  # gradients and loss summed over the ranks
            *summed, loss = flat_all_reduce(list(grads.values()) + [loss],
                                            group)
            grads = dict(zip(grads, summed))
        if place is None:
            gsq = torch.stack(torch._foreach_norm(list(grads.values()))
                              ).square().sum()
        else:
            gsq = place.global_sq(list(grads), list(grads.values()))
        ok = (torch.isfinite(loss) & torch.isfinite(gsq)).float()
        update(params, grads, opt_state, gsq)
        for p in params.values():
            p.grad = None
        if place is None:
            return loss, ok, step_metrics(gsq, params.values())
        with torch.no_grad():
            psq = place.global_sq(list(params), [p.detach() for p in
                                                 params.values()])
        return loss, ok, torch.stack([gsq.float().sqrt(), psq.sqrt()])

    return step


def make_lm_eval_step(cfg: LMTrainConfig, attn_impl: str = "flash",
                      mesh=None):
    """Forward-only masked CE: ``(params, tokens, targets) -> (ce_sum,
    count)``, with the training step's ``matmul_dtype`` and head (the MoE
    aux is no part of it, as in the JAX eval step); no remat (there is no
    backward to keep activations for).  Under ``mesh`` both are summed
    over the ranks, each given its own rows.  ZeRO-3 shards are gathered
    first, with the training step's gather dtype (the JAX eval step sees
    the weights the train forward saw).  Under tp / sp each rank evaluates
    its sequence chunk of its data index's rows on its tp shards, the sums
    taken over its data x seq group."""
    validate_lm_cfg(cfg)
    sync = LMSync(cfg, mesh, param_shapes(cfg.model)) if cfg.fsdp else None
    place = LMPlace.of(cfg, mesh)
    group = place.batch if place is not None else (
        None if mesh is None else mesh_group(mesh))

    @torch.no_grad()
    def eval_step(params, tokens, targets):
        if sync is not None:
            params = sync.gather_all(params, cfg.fsdp_gather_dtype)
        if place is not None:
            tokens, targets = place.seq_chunk(tokens), place.seq_chunk(targets)
        apply_kw, head_kw = _model_kw(cfg, place, tokens)
        head = partial(losses.head_loss, targets=targets,
                       loss_impl=cfg.loss_impl, loss_chunk=cfg.loss_chunk,
                       **head_kw)
        ce, n = tfm.apply(params, tokens, cfg=cfg.model, dtype=cfg.dtype,
                          attn_impl=attn_impl, head_fn=head,
                          matmul_dtype=cfg.matmul_dtype, **apply_kw)
        if mesh is not None:
            ce, n = flat_all_reduce([ce.float(), n.float()], group)
        return ce, n

    return eval_step


class LMTrainer:
    """Owns this rank's float32 ``params`` and Adam ``opt_state`` (with
    ``fsdp``, its ZeRO-3 shards of both) and, under ``dcn_compress``, its
    error-feedback residual ``sync_state``.

    ``cfg.dp = N > 1`` trains data parallel over ``mesh`` (given, or made
    by ``make_lm_mesh`` over the default process group, whose world size
    must be N: one process a device, ``launch.py --nproc-per-node N``;
    otherwise ``NotImplementedError`` naming the launcher); ``dcn_size > 1``
    needs the ``("dcn", "data")`` mesh ``make_lm_mesh`` builds.  A mesh may
    be given at ``dp = 1`` too: a gang of one, whose step issues its
    collectives over a one-rank group.  Every rank calls ``train_step``
    with its own ``B / N`` rows and ``evaluate`` with its own batches.

    ``device`` defaults to ``"cuda"`` (``cuda:{LOCAL_RANK}`` under a mesh)
    and raises without a GPU unless ``"cpu"`` is asked for.  Params are
    drawn by the port's own ``init`` from ``cfg.seed`` (not the JAX
    package's draws), rank 0's broadcast; ``load_state`` takes whole params,
    optimizer state and a residual carried from a JAX run (convert.py).
    ``full_params`` gathers the whole params (every rank must call it).
    Under ``sync_every > 1`` (``window``, ``LMWindowSteps``) ``params``
    are the anchor, which ``evaluate`` and ``full_params`` read; the
    rank's delta, pending exchange and outer momentum sit beside them.
    ``attn_impl`` chooses the attention of the forward (``"flash"``, the
    JAX package's default, or ``"reference"``)."""

    def __init__(self, cfg: LMTrainConfig,
                 device: str | torch.device = "cuda",
                 attn_impl: str = "flash", mesh=None):
        validate_lm_cfg(cfg)
        self.cfg = cfg
        if mesh is None and n_ranks(cfg) > 1:
            mesh = make_lm_mesh(cfg, device=device)  # a gang of ranks
        if mesh is not None:
            if mesh.size() != n_ranks(cfg):
                raise ValueError(
                    f"mesh has {mesh.size()} ranks, config wants "
                    f"dp={cfg.dp}" + (f" x sp={cfg.sp} x tp={cfg.tp}"
                                      if model_parallel(cfg) else ""))
            self.device = ensure_process_group(device)
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.rank = dist.get_rank() if mesh is not None else 0
        self.place = LMPlace.of(cfg, mesh)
        self.attn_impl = attn_impl
        self.sync = (LMSync(cfg, mesh, param_shapes(cfg.model))
                     if sharded(cfg) else None)
        self.params = self._leaves(tfm.init(cfg.seed, cfg.model,
                                            device=self.device))
        self.opt_state = init_opt_state(self.params)
        self.sync_state = torch.zeros(lm_sync_state_len(cfg),
                                      dtype=torch.float32,
                                      device=self.device)
        self.window = None  # the sync windows' programs (sync_every > 1)
        self._window_wire_bytes = None
        self._build_steps()
        self._init_window_state()
        self._eval_fn = make_lm_eval_step(cfg, attn_impl, mesh)
        self._step = 0
        self.last_ok = None       # health flag of the last step (tensor)
        self.last_metrics = None  # [grad-norm, param-norm] of the last step
        self._ckptr = None        # the cached checkpointer and its key
        self._ckptr_key = None
        self.restored_meta: dict = {}

    def _build_steps(self) -> None:
        """The step (or the sync windows' programs) for ``self.cfg``: the
        optimizer captures ``grad_clip`` when built."""
        cfg, mesh = self.cfg, self.mesh
        kind = "localsgd" if cfg.sync_every > 1 else (
            "sharded" if sharded(cfg) else "dp" if mesh is not None
            else "single")
        with monitor.compile_span(
                "lm_step_build", kind=kind,
                key=(kind, cfg.grad_clip, cfg.dp, cfg.dcn_size)):
            if cfg.sync_every > 1:
                self.step_fn = None
                self.window = LMWindowSteps(
                    cfg, mesh, make_optimizer(cfg),
                    partial(_loss_fn, cfg, self.attn_impl,
                            n_ranks=mesh.size()))
                self._window_wire_bytes = _lm_window_wire_bytes(cfg)
            else:
                self.step_fn = make_lm_train_step(cfg, self.attn_impl, mesh)

    def tighten_grad_clip(self, factor: float = 0.5) -> float:
        """Multiply the gradient-clip norm by ``factor`` and rebuild the
        step, whose optimizer captured the old norm: the training sentry's
        mid-ladder escalation (utils/sentry.py).  The clip is stateless,
        so the live optimizer state carries over.  Returns the new
        norm."""
        self.cfg.grad_clip *= factor
        self._build_steps()
        return self.cfg.grad_clip

    def _init_window_state(self) -> None:
        """Under sync windows: this rank's zero delta (the params' layout),
        no pending exchange, and with a non-trivial ``outer_opt`` the
        float32 zero outer momentum (the anchor's layout); ``params`` stay
        the anchor, the last exchanged point."""
        self._delta = self._outer_m = self._pending = None
        self._window_t0 = None  # host clock at the window's first step
        self._outer_steps = 0   # outer-optimizer steps applied
        if self.window is None:
            return
        self._delta = {n: torch.zeros_like(p, requires_grad=False)
                       for n, p in self.params.items()}
        if self.window.outer is not None:
            self._outer_m = dict(zip(self.params, self.window.outer
                                     .init_state(self.params.values())))

    def _shard(self, tree: dict) -> dict:
        """This rank's ZeRO-3 (or tp) shards of whole leaves (copies)."""
        if self.place is not None:
            return {n: self.place.shard(n, t).clone()
                    for n, t in tree.items()}
        if self.sync is None:
            return tree
        return {n: self.sync.shard(n, t).clone() for n, t in tree.items()}

    def _leaves(self, params: dict) -> dict[str, torch.Tensor]:
        """Float32 leaves on this device that require grad (this rank's
        shards of them with ``fsdp`` or ``tp``); rank 0's values on every
        rank of the mesh."""
        out = {n: p.detach().to(self.device, torch.float32).clone()
               for n, p in params.items()}
        if self.mesh is not None:
            group = mesh_group(self.mesh)
            src = dist.get_global_rank(group, 0) if group is not None else 0
            for t in out.values():
                dist.broadcast(t, src=src, group=group)
        return {n: t.requires_grad_(True)
                for n, t in self._shard(out).items()}

    def load_state(self, params: dict, opt_state: dict | None = None,
                   sync_state: torch.Tensor | None = None) -> None:
        """Take whole params (the port's flat dict, e.g. from
        ``convert.from_jax_params``), optionally the Adam state
        (``convert.from_jax_opt_state``, whole moments; under sync windows
        this rank's slice's row) and this rank's residual
        (``convert.from_jax_sync_state``); with ``fsdp`` or ``tp`` each is
        cut to this rank's shard.  The step count follows the optimizer state's,
        or restarts at 0 without one; a sync window restarts from the
        loaded point (zero delta and outer momentum)."""
        if sorted(params) != sorted(self.params):
            raise ValueError("params do not match the model's parameter "
                             "names")
        self.params = self._leaves(params)
        if opt_state is None:
            self.opt_state = init_opt_state(self.params)
        else:
            self.opt_state = {
                "count": int(opt_state["count"]),
                **{m: self._shard({n: opt_state[m][n].detach().to(
                    self.device, torch.float32).clone() for n in self.params})
                   for m in ("mu", "nu")}}
        if sync_state is not None:
            if sync_state.shape != self.sync_state.shape:
                raise ValueError(f"sync_state of shape "
                                 f"{tuple(sync_state.shape)}, want "
                                 f"{tuple(self.sync_state.shape)}")
            self.sync_state = sync_state.to(self.device, torch.float32)
        self._step = self.opt_state["count"]
        self._init_window_state()

    @torch.no_grad()
    def full_params(self) -> dict[str, torch.Tensor]:
        """The whole params (ZeRO-3 leaves gathered in full precision, as
        the JAX CLI fetches them for generation; tp shards gathered over
        ``model``); every rank must call it."""
        if self.place is not None:
            return {n: self.place.gather(n, p.detach())
                    for n, p in self.params.items()}
        if self.sync is None:
            return {n: p.detach() for n, p in self.params.items()}
        return {n: p.detach() if self.sync.dims[n] is None else
                _gather_dim(p.detach(), self.sync.dims[n], self.sync.data)
                for n, p in self.params.items()}

    def _batch(self, tokens, targets):
        return (torch.as_tensor(np.asarray(tokens), device=self.device).long(),
                torch.as_tensor(np.asarray(targets), device=self.device)
                .long())

    def _run_step(self, tokens, targets, step_no=0, fault_arm=0.0):
        """One step of ``step_fn``: ``(loss, ok, met)``."""
        if self.sync is not None:
            loss, ok, met, self.sync_state = self.step_fn(
                self.params, self.opt_state, tokens, targets,
                self.sync_state, step_no=step_no, fault_arm=fault_arm)
            return loss, ok, met
        return self.step_fn(self.params, self.opt_state, tokens, targets,
                            step_no=step_no, fault_arm=fault_arm)

    def _fault_arm(self) -> float:
        """The host's arming of the fault taps for the step about to run
        (0.0, and nothing consumed, with no step plan installed)."""
        return (faults.arm_window(self._step)
                if faults.step_plan() is not None else 0.0)

    def train_step(self, tokens: np.ndarray, targets: np.ndarray):
        """One optimizer step on a (B, S) batch (this rank's rows under a
        mesh); returns the global batch's loss as a 0-dim tensor (not
        fetched to the host).  The fault hooks run around it: a straggler
        plan's sleep before, the taps' arming, an injected crash after."""
        faults.maybe_delay(self._step)
        tokens, targets = self._batch(tokens, targets)
        if self.window is not None:
            return self._train_step_windowed(tokens, targets)
        arm = self._fault_arm()
        t0 = time.perf_counter()
        loss, self.last_ok, self.last_metrics = self._run_step(
            tokens, targets, self._step, arm)
        self._step += 1
        faults.maybe_crash(self._step, before_exit=self.flush_checkpoints)
        tel = telemetry.active()
        if tel is not None:
            telemetry.emit_train_steps(
                tel, t0, self._step - 1, 1, *tracing.lazy_host(
                    loss, self.last_ok, self.last_metrics),
                span_name="lm_train_step")
        return loss

    def train_steps(self, tokens: np.ndarray, targets: np.ndarray):
        """``K = tokens.shape[0]`` optimizer steps over stacked (K, B, S)
        batches (this rank's rows of each under a mesh), the trajectory of
        K ``train_step`` calls; returns the K losses as a (K,) tensor, with
        ``last_ok`` (K,) and ``last_metrics`` (K, 2).  The JAX ``lax.scan``
        of ``make_lm_multi_step``, here a loop over the same step; it takes
        neither the pipeline, gradient accumulation, the compressed
        residual nor sync windows, with the JAX trainer's messages."""
        cfg = self.cfg
        if cfg.pp > 1 or cfg.pp_size > 0:
            raise ValueError("train_steps (K-step scan) supports the "
                             "(data, expert, seq, model) layout; with pp "
                             "or pp_size use train_step")
        if cfg.grad_accum > 1:
            raise ValueError("train_steps does not implement gradient "
                             "accumulation; use train_step with "
                             "grad_accum, or stack more steps instead")
        if cfg.dcn_compress is not None:
            raise ValueError("train_steps does not thread the stateful "
                             "sync-state (EF residual) carry; with "
                             "dcn_compress use train_step")
        if cfg.sync_every > 1:
            raise ValueError("train_steps does not thread the window "
                             "delta / per-slice optimizer carries; with "
                             "sync_every > 1 use train_step")
        tokens, targets = self._batch(tokens, targets)
        k = tokens.shape[0]
        t0 = time.perf_counter()
        out = [self._run_step(tokens[i], targets[i]) for i in range(k)]
        losses, oks, mets = (torch.stack(x) for x in zip(*out))
        self.last_ok, self.last_metrics = oks, mets
        self._step += k
        faults.maybe_crash(self._step, k, before_exit=self.flush_checkpoints)
        tel = telemetry.active()
        if tel is not None:
            telemetry.emit_train_steps(
                tel, t0, self._step - k, k, *tracing.lazy_host(
                    losses, oks, mets), span_name="lm_train_steps")
        return losses

    def _train_step_windowed(self, tokens, targets):
        """One local step of the ``sync_every = H`` schedule, then what the
        step count makes due: the exchange at multiples of H (its launch
        with ``staleness = S > 0``, and the deferred apply at kH + S); with
        ``sync_every_per_slice`` the exchange masks out each slice whose
        interval does not divide the step."""
        w, cfg = self.window, self.cfg
        h, s = cfg.sync_every, cfg.staleness
        arm = self._fault_arm()
        t0 = time.perf_counter()
        if self._step % h == 0:
            self._window_t0 = t0
        loss, self.last_ok, self.last_metrics = w.local_step(
            self.params, self._delta, self.opt_state, tokens, targets,
            step_no=self._step, fault_arm=arm)
        self._step += 1
        boundary = self._step % h == 0
        if boundary:
            if s == 0:
                per = cfg.sync_every_per_slice
                mask = None if per is None else \
                    [1.0 if self._step % hi == 0 else 0.0 for hi in per]
                self.sync_state, self._outer_m = w.exchange(
                    self.params, self._delta, self.sync_state,
                    self._outer_m, mask)
                if self._outer_m is not None:
                    self._outer_steps += 1
            else:
                d_avg, snap, self.sync_state = w.launch(self._delta,
                                                        self.sync_state)
                self._pending = (d_avg, snap)
        elif self._pending is not None and self._step % h == s:
            d_avg, snap = self._pending
            self._pending = None
            self._outer_m = w.apply_pending(self.params, self._delta, d_avg,
                                            snap, self._outer_m)
            if self._outer_m is not None:
                self._outer_steps += 1
        faults.maybe_crash(self._step, before_exit=self.flush_checkpoints)
        tel = telemetry.active()
        if tel is not None:
            telemetry.emit_train_steps(
                tel, t0, self._step - 1, 1, *tracing.lazy_host(
                    loss, self.last_ok, self.last_metrics),
                span_name="lm_train_step")
            if boundary and self._window_t0 is not None:
                telemetry.emit_sync_windows(
                    tel, self._window_t0, self._step - h, h, h,
                    wire_bytes=self._window_wire_bytes, phase="train")
                if (cfg.sync_every_per_slice is not None
                        or self._outer_m is not None):
                    telemetry.emit_window_plan(
                        tel, step=self._step - 1,
                        sync_every_per_slice=cfg.sync_every_per_slice,
                        outer_steps=(self._outer_steps
                                     if self._outer_m is not None
                                     else None), phase="train")
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

    # -- checkpointing ----------------------------------------------------
    def _checkpointer(self, directory: str, sharded: bool = False):
        """One cached checkpointer per (directory, format): the whole-tree
        async writer's background handle survives across saves."""
        from .utils.checkpoint import PyTreeCheckpointer, ShardedCheckpointer
        key = (directory, sharded)
        if self._ckptr_key != key:
            self._ckptr = (ShardedCheckpointer(directory) if sharded
                           else PyTreeCheckpointer(directory,
                                                   async_write=True))
            self._ckptr_key = key
        return self._ckptr

    def flush_checkpoints(self) -> None:
        """Block until any in-flight background checkpoint write has been
        published."""
        if self._ckptr is not None:
            self._ckptr.wait()

    def _pieces(self, tree: dict, stacked: bool) -> dict:
        """This rank's leaves of ``tree`` (params' layout) as the
        ``Shard``s of the global arrays they are: a ZeRO-3 leaf the
        ``narrow`` of its dim at this rank's ``data`` index, a replicated
        leaf whole (rank 0's copy written); ``stacked`` (a sync window's
        optimizer state, one row a slice) adds the leading ``dcn`` axis.
        Under tp a sharded leaf is the ``narrow`` of its dim at this
        rank's ``model`` index, one copy a data x seq group (written by
        the group's first rank)."""
        from .utils.checkpoint import Shard, full_index
        shapes = param_shapes(self.cfg.model)
        out = {}
        for n, t in tree.items():
            shape = tuple(shapes[n])
            if self.place is not None:
                dim = self.place.tp_dims[n]
                index = list(full_index(shape))
                replica = self.rank
                if dim is not None:
                    m = shape[dim] // self.cfg.tp
                    r = self.place.model_index
                    index[dim] = slice(r * m, (r + 1) * m)
                    replica = dist.get_rank(self.place.batch)
                out[n] = Shard(t.detach(), shape, tuple(index), replica)
                continue
            dim = self.sync.dims[n] if self.sync is not None else None
            index = list(full_index(shape))
            if dim is not None:
                m = shape[dim] // self.sync.n_data
                r = self.sync.data_rank
                index[dim] = slice(r * m, (r + 1) * m)
            data = t.detach()
            if stacked:
                s = self.window.slice
                shape = (self.cfg.dcn_size,) + shape
                index = [slice(s, s + 1)] + index
                data = data.unsqueeze(0)
                replica = 0 if dim is not None else self.sync.data_rank
            elif dim is None:
                replica = self.rank
            else:
                replica = (dist.get_rank(self.sync.dcn)
                           if self.sync.dcn is not None else 0)
            out[n] = Shard(data, shape, tuple(index), replica)
        return out

    def _whole(self, tree: dict, stacked: bool) -> dict:
        """The global arrays of this rank's leaves (ZeRO-3 shards gathered
        over ``data``; ``stacked`` rows gathered over ``dcn``): every rank
        must call it; tp shards gathered over ``model``)."""
        out = {}
        for n, t in tree.items():
            t = t.detach()
            if self.place is not None:
                out[n] = self.place.gather(n, t)
                continue
            dim = self.sync.dims[n] if self.sync is not None else None
            if dim is not None:
                t = _gather_dim(t, dim, self.sync.data)
            if stacked:
                t = _gather_dim(t.unsqueeze(0), 0, self.sync.dcn)
            out[n] = t
        return out

    def _ckpt_trees(self, pieces: bool) -> dict:
        stacked = self.window is not None
        conv = self._pieces if pieces else self._whole
        return {"params": conv(self.params, False),
                "opt": {"count": self.opt_state["count"],
                        **{m: conv(self.opt_state[m], stacked)
                           for m in ("mu", "nu")}}}

    def save_checkpoint(self, directory: str,
                        extra_meta: dict | None = None,
                        sharded: bool = False) -> None:
        """Snapshot params, Adam state and the step (utils/checkpoint.py);
        every rank must call it.  Default format: one whole-tree npz (the
        ZeRO-3 shards gathered, each sync-window slice's optimizer row
        stacked), fetched synchronously, with the checksums, serialization
        and IO on a background thread (``async_write``).  ``sharded=True``
        writes each rank's own pieces instead (no gather, no full-tree host
        copy).  ``extra_meta`` rides along in the JSON meta (the CLI's
        loader position)."""
        trees = self._ckpt_trees(pieces=sharded)
        self._checkpointer(directory, sharded).save(
            trees, self._step,
            meta=dict(extra_meta or {},
                      dp=self.cfg.dp, sp=self.cfg.sp, tp=self.cfg.tp,
                      pp=self.cfg.pp, interleave=self.cfg.interleave))

    def maybe_restore(self, directory: str) -> int:
        """Restore the latest checkpoint if there is one; returns the step
        to resume from (0 = fresh).  The format is detected, and in a
        directory of both the newest step wins; the checkpoint's meta
        (with any ``extra_meta``) lands in ``self.restored_meta``.  A
        per-shard checkpoint restores through ``load_resharded``: the
        layout of the save or another one, each piece cut from the saved
        pieces that intersect it.  A sync window restarts from the
        restored anchor with a zero delta."""
        from .utils.checkpoint import PyTreeCheckpointer, ShardedCheckpointer
        sh_list = ShardedCheckpointer(directory).list()
        npz_list = PyTreeCheckpointer(directory).list()
        if not sh_list and not npz_list:
            return 0
        sharded = bool(sh_list) and (
            not npz_list or sh_list[-1][0] >= npz_list[-1][0])
        ckptr = self._checkpointer(directory, sharded)
        load = ckptr.load_resharded if sharded else ckptr.restore
        got = load(self._ckpt_trees(pieces=True))
        if got is None:
            return 0
        trees, meta = got
        stacked = self.window is not None
        self.params = {n: t.requires_grad_(True)
                       for n, t in trees["params"].items()}
        self.opt_state = {"count": int(trees["opt"]["count"]),
                          **{m: {n: t[0] if stacked else t for n, t in
                                 trees["opt"][m].items()}
                             for m in ("mu", "nu")}}
        self._step = meta["step"]
        self._init_window_state()
        self.restored_meta = meta
        return self._step

    # -- elastic resize ---------------------------------------------------
    def _carried(self, tree: dict, stacked: bool) -> dict:
        """Whole copies of this rank's leaves of ``tree`` (params' layout),
        the same on every rank: ZeRO-3 shards gathered over ``data``, and
        ``stacked`` (a window's per-slice rows) slice 0's row broadcast
        over ``dcn``.  Every rank must call it."""
        out = {}
        for n, t in tree.items():
            t = t.detach()
            dim = self.sync.dims[n] if self.sync is not None else None
            if dim is not None:
                t = _gather_dim(t, dim, self.sync.data)
            out[n] = t.clone()
        if stacked:
            dcn = self.sync.dcn
            src = dist.get_global_rank(dcn, 0)
            for t in out.values():
                dist.broadcast(t, src=src, group=dcn)
        return out

    def rebuild(self, mesh=None, **overrides) -> None:
        """Rebuild the step with ``LMTrainConfig`` field ``overrides``
        (``sync_every``, ``sync_every_per_slice``, ``fsdp``, the clip, the
        precision knobs, ...), carrying the live state across: the params
        (the anchor under a window) and Adam state, whole then re-cut for
        the new layout, and the step counter.  A window's per-slice Adam
        rows collapse to slice 0's; the residual, the un-exchanged window
        delta and the outer momentum start again (the JAX trainer's carry
        rules).  ``mesh`` (default: this trainer's, or ``make_lm_mesh``'s
        when the ``dcn`` extent changed) must span the ranks there are.

        A pipeline config raises ``ValueError`` (JAX's message), and so
        does a mesh whose size is not ``dp``.  A ``dp`` other than the
        process group's world size raises ``NotImplementedError``: one
        process drives one device, so a gang changes size by the elastic
        agent's drain and re-rendezvous, as the JAX trainer's
        multi-process gangs do.  Every rank must call it."""
        import dataclasses
        cfg = (dataclasses.replace(self.cfg, **overrides) if overrides
               else self.cfg)
        if model_parallel(self.cfg) or model_parallel(cfg):
            raise tfm.not_ported(
                f"LMTrainer.rebuild with tp={cfg.tp}, sp={cfg.sp}",
                COMPOSE_SLICE)
        if cfg.pp > 1 or cfg.pp_size > 0:
            raise ValueError(
                "cannot resize a pipeline (pp/pp_size) config for now: "
                "stage placement is baked into the hand-emitted step — "
                "relaunch at the new size instead")
        validate_lm_cfg(cfg)
        if mesh is not None and mesh.size() != cfg.dp:
            raise ValueError(
                f"resized mesh has {mesh.size()} devices, config wants "
                f"{cfg.dp}")
        if cfg.dp != (self.mesh.size() if self.mesh is not None else 1):
            one_process_per_device(cfg.dp)  # a gang resizes by relaunch
        if mesh is None and (self.mesh is not None or cfg.dp > 1):
            same = (self.mesh is not None
                    and self.cfg.dcn_size == cfg.dcn_size)
            mesh = self.mesh if same else make_lm_mesh(cfg, self.device)
        stacked = self.window is not None
        params = self._carried(self.params, False)
        moments = {m: self._carried(self.opt_state[m], stacked)
                   for m in ("mu", "nu")}
        count = self.opt_state["count"]
        self.cfg = cfg
        self.mesh = mesh
        self.sync = (LMSync(cfg, mesh, param_shapes(cfg.model))
                     if sharded(cfg) else None)
        self.params = self._leaves(params)
        self.opt_state = {"count": count,
                          **{m: self._shard(moments[m])
                             for m in ("mu", "nu")}}
        self.sync_state = torch.zeros(lm_sync_state_len(cfg),
                                      dtype=torch.float32,
                                      device=self.device)
        self.window = None
        self._window_wire_bytes = None
        self._build_steps()
        self._init_window_state()
        self._eval_fn = make_lm_eval_step(cfg, self.attn_impl, mesh)
        self.last_ok = None
        self.last_metrics = None
