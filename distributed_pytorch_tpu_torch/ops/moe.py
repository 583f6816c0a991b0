"""Mixture-of-Experts layer on one device: the port of the JAX package's
ops/moe.py (``moe_init``, ``moe_apply``).

What it computes is the JAX layer's, value for value:

- **Routing** in float32: ``logits = x @ router``, softmax over the E
  experts, and the router z-loss (the mean squared logsumexp of the
  logits, ST-MoE) weighted by ``z_coef`` into the returned aux.
- **Token choice** (``router_mode="tokens"``): each token picks its
  ``top_k`` (1 or 2) experts; Switch gates (the raw probability) for top-1,
  gates normalized over the pair for top-2.  The load-balance aux
  ``E * sum_e f_e * p_e`` counts the primary choice only.  Slots fill in
  stream order, every choice-1 token before any choice-2 token (a cumsum
  over the ``(K T, E)`` one-hots), and an expert takes at most
  ``cap = min(max(1, ceil(T K cf / E)), T)`` of them: overflow is dropped
  (its output row is zero, the residual stream carries the token).
- **Expert choice** (``router_mode="experts"``): each expert takes its
  top-``cap`` tokens by router probability; a token's output is the
  gate-weighted sum over every expert that took it; the aux is
  ``z_coef * z_loss`` alone (balanced by construction).
- **Experts**: batched SwiGLU over the ``(E, C, D)`` slot buffer,
  ``silu(x W_gate) * (x W_up) @ W_down`` with the weights cast to x's dtype.

**Dispatch by index** (a deliberate divergence in form, not in value): the
JAX layer builds a one-hot ``(T, E, C)`` dispatch tensor and contracts it
twice; here each kept token is gathered into its ``(E, C, D)`` slot and the
gate-weighted expert rows are gathered (token choice) or scatter-added
(expert choice) back.  Every output element of the JAX einsums has one
non-zero product (top-1), two (top-2) or one per choosing expert (expert
choice), and adding exact zeros changes nothing.  The products and their
sum are taken in a wider type and rounded once to x's dtype: float32 for
bfloat16 x (each product exact, as in the einsum's float32 accumulation;
two bf16 adds would round twice), float64 for float32 x (so that a
top-2 pair or an expert-choice sum rounds once, whatever order a GEMM
would add it in).  At LM-base the one-hot tensor would be
8192 x 8 x 2048 elements a layer and its two einsums ~275 GFLOP each.
``moe_apply_plain`` is the literal one-hot form, the oracle of the tests
and of chip_smoke.py; nothing on the main path calls it.

The gathers are ``index_select``s: their backward adds rows by index
(``index_add``), where advanced indexing's backward sorts the indices and
walks each repeated one serially, and a buffer's empty slots all repeat
the one zero row (on the H100 that backward took half the MoE step's
device time).  The rows a backward adds at a repeated index are exact
zeros (an empty slot's or a dropped choice's gradient), so the order of
the adds changes nothing.

**Ties**: ``lax.top_k`` puts the lower index first among equal values;
``torch.topk`` promises no order, so the top-k choices come from a stable
descending sort.

Expert parallelism (``axis``: the all-to-all dispatch, ``dispatch_bits``,
``a2a_chunks``) belongs to slice 5d and raises ``NotImplementedError``;
without an axis the JAX package's value errors are raised, with its
messages.  The layer runs no hand-written kernel: it is GEMMs and gathers,
what XLA lowers by itself in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Params = dict[str, torch.Tensor]

EP_SLICE = ("ROADMAP.md queue 1, slice 5d (model parallelism: expert "
            "parallelism)")


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, device: torch.device,
             dtype: torch.dtype = torch.float32) -> Params:
    """Router (D, E) and per-expert SwiGLU stacks w_gate/w_up (E, D, F),
    w_down (E, F, D): normal / sqrt(fan_in), the JAX shapes and scales
    (torch's draws, not JAX's)."""
    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) / math.sqrt(fan_in)
        return w.to(dtype)

    return {"router": dense((d_model, n_experts), d_model),
            "w_gate": dense((n_experts, d_model, d_ff), d_model),
            "w_up": dense((n_experts, d_model, d_ff), d_model),
            "w_down": dense((n_experts, d_ff, d_model), d_ff)}


def _check(e: int, top_k: int, router_mode: str, dispatch_bits: str,
           a2a_chunks: int, axis) -> None:
    """The JAX ``moe_apply`` value checks, in its order, for one device;
    an expert-parallel ``axis`` is refused first."""
    if axis is not None:
        raise NotImplementedError(
            f"moe_apply axis={axis!r} (expert parallelism) is not ported "
            f"to PyTorch yet: {EP_SLICE}")
    if router_mode not in ("tokens", "experts"):
        raise ValueError(f"router_mode must be 'tokens' or 'experts', "
                         f"got {router_mode!r}")
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    if router_mode == "experts" and top_k != 1:
        raise ValueError("expert-choice routing has no top_k (experts pick "
                         "tokens); leave top_k=1")
    if dispatch_bits not in ("f32", "int8", "int4"):
        raise ValueError(f"dispatch_bits must be f32, int8, or int4, "
                         f"got {dispatch_bits!r}")
    if dispatch_bits != "f32":
        raise ValueError(
            f"dispatch_bits={dispatch_bits!r} quantizes the expert "
            f"all_to_all wire; without an expert-parallel axis there is "
            f"no wire to compress (the local einsum path is exact)")
    if a2a_chunks < 1:
        raise ValueError(f"a2a_chunks must be >= 1, got {a2a_chunks}")
    if a2a_chunks > 1:
        raise ValueError(
            f"a2a_chunks={a2a_chunks} pipelines the dispatch/combine "
            f"all_to_alls against the expert FFN; without an "
            f"expert-parallel axis there is no exchange to overlap")


def capacity(t: int, e: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert: ``min(max(1, ceil(T K cf / E)), T)`` in Python
    floats, as the JAX layer computes it."""
    return min(max(1, math.ceil(t * top_k * capacity_factor / e)), t)


def top_k_stable(v: torch.Tensor, k: int) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The ``k`` largest values along the last dim and their indices, the
    lower index first among equal values (``lax.top_k``'s order)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: Params, x: torch.Tensor, z_coef: float):
    """Float32 router logits -> (probs (T, E), z_loss)."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    return probs, z_loss


def acc_dtype(dt: torch.dtype) -> torch.dtype:
    """The type the combine multiplies and adds in (module docstring)."""
    return torch.float64 if dt == torch.float32 else torch.float32


def expert_ffn(params: Params, xe: torch.Tensor) -> torch.Tensor:
    """Batched SwiGLU over the (E, C, D) slot buffer."""
    dt = xe.dtype
    g = F.silu(torch.bmm(xe, params["w_gate"].to(dt)))
    u = torch.bmm(xe, params["w_up"].to(dt))
    return torch.bmm(g * u, params["w_down"].to(dt))


def token_slots(top_idx: torch.Tensor, e: int, cap: int):
    """Slot of each (token, choice) in its expert's buffer: stream order,
    every choice-1 token before any choice-2 token.  Returns ``(slot
    (T, K) int64, keep (T, K) bool)``."""
    t, k = top_idx.shape
    # (E, K T): the running count along the last dim, a row scan each
    # (a scan down the first dim of (K T, E) runs E threads serially)
    flat = F.one_hot(top_idx.t().reshape(-1), e).t()
    pos = (flat.cumsum(1) * flat).sum(0).reshape(k, t).t()  # 1-based
    return pos - 1, pos <= cap


def moe_apply(params: Params, x: torch.Tensor, *, n_experts: int,
              capacity_factor: float = 2.0, axis=None, top_k: int = 1,
              router_mode: str = "tokens", z_coef: float = 0.0,
              dispatch_bits: str = "f32", a2a_chunks: int = 1,
              stats: dict | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, D) tokens -> (out (T, D) in x's dtype, float32 aux scalar), by
    index dispatch (module docstring).  ``stats``, when given, receives
    ``kept`` (the (token, choice) pairs or slots that reached an expert)
    and ``routed`` (all of them) as device tensors, for a drop share."""
    t, d = x.shape
    e = n_experts
    _check(e, top_k, router_mode, dispatch_bits, a2a_chunks, axis)
    cap = capacity(t, e, top_k, capacity_factor)
    probs, z_loss = route(params, x, z_coef)
    dt = x.dtype
    acc = acc_dtype(dt)

    if router_mode == "experts":
        g, idx = top_k_stable(probs.t(), cap)              # (E, C)
        xin = x.index_select(0, idx.reshape(-1)).reshape(e, cap, d)
        y = expert_ffn(params, xin)
        contrib = g.to(dt).to(acc)[..., None] * y.to(acc)
        out = torch.zeros((t, d), device=x.device, dtype=acc)
        out = out.index_add(0, idx.reshape(-1), contrib.reshape(-1, d))
        if stats is not None:  # tokens no expert took are dropped
            stats.update(kept=torch.zeros(t, device=x.device).index_fill(
                0, idx.reshape(-1), 1).sum(), routed=torch.tensor(t))
        return out.to(dt), (z_coef * z_loss).float()

    top_probs, top_idx = top_k_stable(probs, top_k)         # (T, K)
    gates = top_probs if top_k == 1 else \
        top_probs / top_probs.sum(-1, keepdim=True)
    frac = F.one_hot(top_idx[:, 0], e).float().mean(0)
    aux = e * (frac * probs.mean(0)).sum() + z_coef * z_loss
    slot, keep = token_slots(top_idx, e, cap)
    # slot buffer row of each kept choice; dropped choices point at a
    # zero row past the buffer (gather) and carry a zero gate (combine)
    row = torch.where(keep, top_idx * cap + slot, e * cap)  # (T, K)
    src = torch.full((e * cap + 1,), t, dtype=torch.long, device=x.device)
    src[row.reshape(-1)] = torch.arange(t * top_k, device=x.device) // top_k
    xz = torch.cat([x, x.new_zeros((1, d))])
    xin = xz.index_select(0, src[:-1]).reshape(e, cap, d)   # (E, C, D)
    y = expert_ffn(params, xin).reshape(e * cap, d)
    y_sel = y.index_select(0, torch.where(keep, row, 0).reshape(-1)
                           ).reshape(t, top_k, d)           # (T, K, D)
    g = torch.where(keep, gates.to(dt), 0).to(acc)
    out = (g[..., None] * y_sel.to(acc)).sum(1)
    if stats is not None:
        stats.update(kept=keep.sum(), routed=torch.tensor(keep.numel()))
    return out.to(dt), aux.float()


def moe_apply_plain(params: Params, x: torch.Tensor, *, n_experts: int,
                    capacity_factor: float = 2.0, top_k: int = 1,
                    router_mode: str = "tokens", z_coef: float = 0.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX layer's literal one-hot form (``(T, E, C)`` dispatch and
    combine tensors contracted by einsum, in ``acc_dtype``): the oracle of
    ``moe_apply``."""
    t, d = x.shape
    e = n_experts
    _check(e, top_k, router_mode, "f32", 1, None)
    cap = capacity(t, e, top_k, capacity_factor)
    probs, z_loss = route(params, x, z_coef)
    dt = x.dtype
    if router_mode == "experts":
        g, idx = top_k_stable(probs.t(), cap)
        sel = F.one_hot(idx, t).to(dt)                      # (E, C, T)
        dispatch = sel.permute(2, 0, 1)
        combine = torch.einsum("ect,ec->tec", sel, g.to(dt))
        aux = z_coef * z_loss
    else:
        top_probs, top_idx = top_k_stable(probs, top_k)
        gates = top_probs if top_k == 1 else \
            top_probs / top_probs.sum(-1, keepdim=True)
        onehots = F.one_hot(top_idx, e).float()             # (T, K, E)
        frac = onehots[:, 0].mean(0)
        aux = e * (frac * probs.mean(0)).sum() + z_coef * z_loss
        flat = onehots.transpose(0, 1).reshape(top_k * t, e)
        pos = (flat.cumsum(0) * flat).reshape(top_k, t, e)
        keep = (pos > 0) & (pos <= cap)
        # JAX's one_hot of an out-of-range slot is all zeros; keep masks it
        slot = (pos - 1).long().clamp(0, cap - 1)
        dispatch_k = F.one_hot(slot, cap).to(dt) * keep[..., None].to(dt)
        dispatch = dispatch_k.sum(0)                        # (T, E, C)
        combine = torch.einsum("ktec,tk->tec", dispatch_k, gates.to(dt))
    acc = acc_dtype(dt)
    xin = torch.einsum("tec,td->ecd", dispatch.to(acc), x.to(acc)).to(dt)
    y = expert_ffn(params, xin)
    out = torch.einsum("tec,ecd->td", combine.to(acc), y.to(acc)).to(dt)
    return out, aux.float()
