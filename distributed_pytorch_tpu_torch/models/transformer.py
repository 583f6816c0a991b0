"""Decoder-only transformer LM in PyTorch: the port of the JAX package's
models/transformer.py.

RMSNorm -> causal self-attention with rotary embeddings -> residual,
RMSNorm -> SwiGLU MLP -> residual, tied embedding head.  Parameters are a
flat ``dict[str, Tensor]`` in the JAX package's layouts, so that weights
cross between the two packages by renaming alone (convert.py):

- ``embed`` (V, D), ``final_norm`` (D,);
- ``layers.{i}.wq`` (D, H, Dh), ``wk``/``wv`` (D, Hkv, Dh), ``wo`` (H, Dh, D);
- ``layers.{i}.w_gate``/``w_up`` (D, F), ``w_down`` (F, D);
- ``layers.{i}.attn_norm``/``mlp_norm`` (D,);
- in a Mixture-of-Experts layer (``cfg.is_moe_layer(i)``) the MLP is
  ``layers.{i}.moe.router`` (D, E), ``moe.w_gate``/``moe.w_up`` (E, D, F)
  and ``moe.w_down`` (E, F, D) (ops/moe.py).

The single-device forward runs with ``attn_impl="flash"`` (the default, as
in the JAX package: hand-written kernels K2-K4 on the GPU,
ops/attention.py) or ``"reference"``.  ``matmul_dtype="int8"`` routes the
dense projections through the int8 matmul (ops/quantized.py: kernel K5 on
the GPU; MoE layers take no int8 path, as in the JAX block), and ``remat``
recomputes each layer in the backward.  ``boundary`` is the layer-group
hook of the sync knobs (lm.py: ZeRO-3 gathers and two-level sync
points).  The parallelism options are refused with
``NotImplementedError`` until the slice that ports them (ROADMAP.md
queue 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import attention as attn_ops
from ..ops import moe as moe_ops
from ..ops import quantized as qz
from ..utils.device import resolve_device

Params = dict[str, torch.Tensor]

# The sub-slices of slice 5 still to port, each named by the refusals of
# its work (slices 5a and 5b are ported).
ELASTIC_SLICE = "ROADMAP.md queue 1, slice 5c-iii (elastic)"
PARALLEL_SLICE = "ROADMAP.md queue 1, slice 5d (model parallelism)"
FLEET_SLICE = "ROADMAP.md queue 1, slice 5e (the fleet)"
PLANNING_SLICE = ("ROADMAP.md queue 1, slice 5f (planning, accounting and "
                  "the bench leg)")


def not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet: {where}")


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 4
    n_kv_heads: int | None = None  # grouped-query attention (None = MHA)
    head_dim: int = 128
    d_ff: int | None = None  # default 4*d_model
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # Mixture-of-Experts: 0 = dense; otherwise every ``moe_every``-th
    # layer (counting from layer moe_every-1) has a routed MoE MLP
    # (ops/moe.py).  The two a2a knobs shape the expert-parallel exchange
    # (slice 5d).
    n_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 1
    moe_router: str = "tokens"
    router_z_coef: float = 0.0
    capacity_factor: float = 2.0
    moe_dispatch_bits: str = "f32"
    moe_a2a_chunks: int = 1

    def __post_init__(self):
        kv = self.n_kv_heads if self.n_kv_heads is not None else self.n_heads
        if self.n_heads % kv:
            raise ValueError(f"n_heads {self.n_heads} not divisible by "
                             f"n_kv_heads {kv}")
        if self.moe_dispatch_bits not in ("f32", "int8", "int4"):
            raise ValueError(
                f"moe_dispatch_bits must be f32, int8, or int4, got "
                f"{self.moe_dispatch_bits!r}")
        if self.moe_a2a_chunks < 1:
            raise ValueError(
                f"moe_a2a_chunks must be >= 1, got {self.moe_a2a_chunks}")

    @property
    def ff(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and i % self.moe_every == self.moe_every - 1


PRESETS = {
    "LM-tiny": TransformerConfig(vocab_size=1024, d_model=256, n_layers=2,
                                 n_heads=2),
    "LM-small": TransformerConfig(d_model=768, n_layers=12, n_heads=6),
    "LM-base": TransformerConfig(d_model=1024, n_layers=24, n_heads=8),
}


def init(seed_or_generator: int | torch.Generator, cfg: TransformerConfig,
         device: str | torch.device = "cuda",
         dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters with the JAX package's shapes and scales: ``embed``
    is normal x 0.02, dense weights normal / sqrt(fan_in), norms ones.  The
    draws come from a ``torch.Generator`` on ``device`` (seeded from an
    int, or passed in) and are not the JAX package's draws; to compare the
    two, carry JAX weights across with convert.py."""
    dev = resolve_device(device)
    if isinstance(seed_or_generator, torch.Generator):
        g = seed_or_generator
    else:
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed_or_generator))
    d, h, dh, f, kv = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.ff, cfg.kv_heads

    def normal(shape, scale):
        w = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (w * scale).to(dtype)

    def ones():
        return torch.ones((d,), device=dev, dtype=dtype)

    params: Params = {"embed": normal((cfg.vocab_size, d), 0.02),
                      "final_norm": ones()}
    for i in range(cfg.n_layers):
        lp = {"attn_norm": ones(),
              "wq": normal((d, h, dh), 1 / math.sqrt(d)),
              "wk": normal((d, kv, dh), 1 / math.sqrt(d)),
              "wv": normal((d, kv, dh), 1 / math.sqrt(d)),
              "wo": normal((h, dh, d), 1 / math.sqrt(h * dh)),
              "mlp_norm": ones()}
        if cfg.is_moe_layer(i):
            moe = moe_ops.moe_init(g, d, f, cfg.n_experts, dev, dtype)
            lp.update({f"moe.{k}": v for k, v in moe.items()})
        else:
            lp.update(w_gate=normal((d, f), 1 / math.sqrt(d)),
                      w_up=normal((d, f), 1 / math.sqrt(d)),
                      w_down=normal((f, d), 1 / math.sqrt(f)))
        params.update({f"layers.{i}.{k}": v for k, v in lp.items()})
    return params


def sync_group_index(cfg: TransformerConfig) -> dict[str, int]:
    """Top-level key of the JAX package's param tree -> forward layer group,
    the schedule ``apply(boundary=...)`` walks: the tied embedding first
    (group 0: it is used at both ends of the stack, so its gradient is
    complete only at the very end of the backward), the layers in forward
    order, then final_norm.  ``group_params`` gives a key's port names."""
    idx = {"embed": 0, "final_norm": cfg.n_layers + 1}
    for i in range(cfg.n_layers):
        idx[f"layer{i}"] = i + 1
    return idx


def group_params(names, key: str) -> list[str]:
    """The port names (of ``names``) under the JAX top-level key ``key``:
    ``"embed"``, ``"final_norm"`` or ``"layer{i}"`` (``layers.{i}.*``)."""
    if key.startswith("layer"):
        pre = f"layers.{key[len('layer'):]}."
        return [n for n in names if n.startswith(pre)]
    return [n for n in names if n == key]


ATTN_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")
LAYER_KEYS = ATTN_KEYS + ("w_gate", "w_up", "w_down")
MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def layer(params: Params, i: int) -> Params:
    """Layer ``i``'s parameters under their short names (``wq``, ...); an
    MoE layer's MLP under ``"moe"``, a dict of ``MOE_KEYS``."""
    pre = f"layers.{i}."
    if pre + "moe.router" not in params:
        return {k: params[pre + k] for k in LAYER_KEYS}
    lp = {k: params[pre + k] for k in ATTN_KEYS}
    lp["moe"] = {k: params[f"{pre}moe.{k}"] for k in MOE_KEYS}
    return lp


def param_count(params: Params) -> int:
    return sum(p.numel() for p in params.values())


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to ``x``'s dtype."""
    x32 = x.float()
    rms = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * rms * scale.float()).to(x.dtype)


def rotary(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over (B, H, S, D) with INTERLEAVED pairs
    (``x[..., ::2]``, ``x[..., 1::2]``), as the JAX package does.  ``pos``
    is (S,) absolute positions or (B, S) per-sequence positions."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)       # (D/2,)
    angles = pos[..., None].float() * freqs                      # (S|B,S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if pos.ndim == 2:  # (B, S, D/2) -> broadcast over heads
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def qkv(lp: Params, h: torch.Tensor, pos: torch.Tensor, theta: float):
    """Projections (B, S, D) -> q (B, H, S, Dh), k/v (B, Hkv, S, Dh), with
    rotary applied to q and k."""
    q = torch.einsum("bsd,dhk->bhsk", h, lp["wq"].to(h.dtype))
    k = torch.einsum("bsd,dhk->bhsk", h, lp["wk"].to(h.dtype))
    v = torch.einsum("bsd,dhk->bhsk", h, lp["wv"].to(h.dtype))
    return rotary(q, pos, theta), rotary(k, pos, theta), v


def attn_out(lp: Params, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhsk,hkd->bsd", o, lp["wo"].to(o.dtype))


def mlp(lp: Params, h: torch.Tensor) -> torch.Tensor:
    gate = F.silu(h @ lp["w_gate"].to(h.dtype))
    up = h @ lp["w_up"].to(h.dtype)
    return (gate * up) @ lp["w_down"].to(h.dtype)


def _check_options(attn_impl: str, matmul_dtype=None, **opts) -> None:
    if attn_impl not in ("flash", "reference"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    if matmul_dtype not in (None, "int8"):
        raise ValueError(f"matmul_dtype must be None or 'int8', got "
                         f"{matmul_dtype!r}")
    for name, value in opts.items():
        if value is not None:
            raise not_ported(f"{name}={value!r}", PARALLEL_SLICE)


def block(lp: Params, x: torch.Tensor, *, cfg: TransformerConfig,
          is_moe: bool, pos: torch.Tensor, attn_impl: str = "flash",
          seq_axis=None, tp_axis=None, ep_axis=None, matmul_dtype=None,
          attn_saved: list | None = None,
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One transformer block: (layer params, (B, S, D)) -> (x, aux), aux
    being the layer's MoE aux loss (``ops.moe.moe_apply`` over the B S
    tokens as one routing group; 0 for a dense layer).  GQA repeats the
    k/v heads to H before attention, so autograd sums their gradient back
    over each group.

    ``matmul_dtype="int8"`` runs q/k/v/o and a dense MLP's three products
    (not an MoE layer's experts, as in the JAX block)
    through ``ops.quantized.quantized_matmul`` on 2-D views, as the JAX
    block does: each weight cast to the compute dtype before it is
    quantized, ``wq`` (D, H, Dh) as (D, H Dh), ``wo`` (H, Dh, D) as
    (H Dh, D), the projected (B, S, H, Dh) moved to (B, H, S, Dh).
    ``attn_saved`` is the flash forward's kept ``(o, lse)`` under
    ``remat="selective"`` (``flash_attention(saved=...)``)."""
    _check_options(attn_impl, matmul_dtype, seq_axis=seq_axis,
                   tp_axis=tp_axis, ep_axis=ep_axis)
    b, s, d = x.shape
    q8 = matmul_dtype == "int8"
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    if q8:
        hf = h.reshape(b * s, d)

        def head_proj(w):
            heads, dh = w.shape[1], w.shape[2]
            out = qz.quantized_matmul(hf, w.reshape(d, heads * dh)
                                      .to(h.dtype))
            return out.reshape(b, s, heads, dh).permute(0, 2, 1, 3)

        q, k, v = head_proj(lp["wq"]), head_proj(lp["wk"]), \
            head_proj(lp["wv"])
        q = rotary(q, pos, cfg.rope_theta)
        k = rotary(k, pos, cfg.rope_theta)
    else:
        q, k, v = qkv(lp, h, pos, cfg.rope_theta)
    if cfg.kv_heads != cfg.n_heads:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if attn_impl == "flash":
        o = attn_ops.flash_attention(q, k, v, causal=True, saved=attn_saved)
    else:
        o = attn_ops.attention_reference(q, k, v, causal=True)
    if q8:
        of = o.permute(0, 2, 1, 3).reshape(b * s, -1)
        o = qz.quantized_matmul(of, lp["wo"].reshape(-1, d).to(o.dtype)
                                ).reshape(b, s, d)
    else:
        o = attn_out(lp, o)
    x = x + o
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if is_moe:
        down, aux = moe_ops.moe_apply(
            lp["moe"], h.reshape(b * s, d), n_experts=cfg.n_experts,
            capacity_factor=cfg.capacity_factor, top_k=cfg.moe_top_k,
            router_mode=cfg.moe_router, z_coef=cfg.router_z_coef)
        return x + down.reshape(b, s, d), aux
    if q8:
        hf = h.reshape(b * s, d)
        gate = F.silu(qz.quantized_matmul(hf, lp["w_gate"].to(h.dtype)))
        up = qz.quantized_matmul(hf, lp["w_up"].to(h.dtype))
        down = qz.quantized_matmul(gate * up, lp["w_down"].to(h.dtype)
                                   ).reshape(b, s, d)
    else:
        down = mlp(lp, h)
    return x + down, torch.zeros((), device=x.device)


def apply(params: Params, tokens: torch.Tensor, *, cfg: TransformerConfig,
          dtype: torch.dtype | None = None, attn_impl: str = "flash",
          seq_axis=None, tp_axis=None, ep_axis=None,
          pos0: int = 0, pos: torch.Tensor | None = None,
          return_aux: bool = False, boundary=None, matmul_dtype=None,
          remat=None, head_fn=None):
    """Forward pass: (B, S) int tokens -> (B, S, vocab) float32 logits.

    ``attn_impl`` is ``"flash"`` (the default, as in the JAX package) or
    ``"reference"``.  ``head_fn``, when given, is called as
    ``head_fn(h, params["embed"])`` on the final-norm hidden states in
    place of the logits matmul, and its result is returned where the
    logits would be (the trainer's head-loss seam, ops/losses.py).  With
    ``return_aux`` the result is ``(out, aux)``, aux being the MoE aux
    losses summed over the layers (float32; 0 for a dense model), under
    remat too (it leaves each checkpointed block as its second output).

    ``matmul_dtype="int8"``: the dense projections through the int8 matmul
    (``block``).  ``remat``: ``"full"`` wraps each block in
    ``torch.utils.checkpoint`` (only the layer's input is kept; the
    backward recomputes the whole block, flash forward included);
    ``"selective"`` also keeps the flash forward's ``(o, lse)``, so the
    backward recomputes only the projections and the MLP, as the JAX
    package's ``save_only_these_names("attn_out", "attn_lse")`` policy
    does (with ``attn_impl="reference"`` it keeps nothing more than
    ``"full"``, as there).  ``None``/``"none"`` runs the blocks as they
    are; so does any ``remat`` while autograd is off.

    ``boundary``: a hook ``params = boundary(group, params)`` called at
    every layer-group boundary of ``sync_group_index`` in forward order (the
    embedding's before the lookup, layer i's before its block, final_norm's
    before the head): an identity on values, where lm.py places each
    group's ZeRO-3 gathers and sync points.  It stays outside the
    checkpointed block under ``remat``, so no collective runs twice."""
    _check_options(attn_impl, matmul_dtype, seq_axis=seq_axis,
                   tp_axis=tp_axis, ep_axis=ep_axis)
    if remat not in (None, "none", "full", "selective"):
        raise ValueError(f"unknown remat {remat!r}: expected 'none', 'full' "
                         "or 'selective'")
    use_remat = remat in ("full", "selective") and torch.is_grad_enabled()
    if boundary is not None:
        params = boundary(0, params)  # the tied embedding's group
    x = params["embed"][tokens]
    if dtype is not None:
        x = x.to(dtype)
    if pos is None:
        pos = pos0 + torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), device=x.device)
    for i in range(cfg.n_layers):
        if boundary is not None:
            params = boundary(i + 1, params)
        is_moe = cfg.is_moe_layer(i)
        kw = dict(cfg=cfg, is_moe=is_moe, pos=pos, attn_impl=attn_impl,
                  matmul_dtype=matmul_dtype)
        if use_remat:
            kw["attn_saved"] = [] if remat == "selective" else None
            x, aux = checkpoint(block, layer(params, i), x,
                                use_reentrant=False,
                                preserve_rng_state=False, **kw)
        else:
            x, aux = block(layer(params, i), x, **kw)
        if is_moe:  # a dense layer's aux is 0
            aux_total = aux_total + aux
    if boundary is not None:
        params = boundary(cfg.n_layers + 1, params)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if head_fn is not None:
        out = head_fn(x, params["embed"])
    else:
        out = x.float() @ params["embed"].float().T
    if return_aux:
        return out, aux_total
    return out
