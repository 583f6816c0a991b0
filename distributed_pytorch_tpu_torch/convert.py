"""Weight conversion between the JAX package's parameter pytree and the
port's flat parameter dict.

The port keeps the JAX layouts (models/transformer.py), so conversion is
renaming plus dtype and device, with no transposes: the nested
``{"embed", "final_norm", "layer{i}": {"wq", ...}}`` tree of numpy arrays
becomes ``{"embed", "final_norm", "layers.{i}.wq", ...}`` tensors, and back.

KV caches and page pools cross as they are: the JAX package's
``{"layer{i}": {"k", "v"[, "ks", "vs"]}}`` cache tree has the port's names
and layouts already (``from_jax_cache``).

A ZeRO-3 run (``fsdp``) holds each rank's shards: ``from_jax_lm_sharded``
cuts JAX's whole params (or Adam moments) to one rank's, and
``to_jax_lm_gathered`` puts a gang's shards back together in JAX's tree;
a ``dcn_compress`` run's residual crosses a row a rank
(``from_jax_sync_state``), as the VGG trainer's does.  Under sync windows
the JAX trainer stacks the delta and the Adam moments on a leading
``dcn`` axis, one row a slice; a port rank holds its slice's row
(``from_jax_window_row``, and back over a gang,
``to_jax_window_stacked``).

The optimizer state crosses too: the Adam moments and step count of an
optax ``chain(clip_by_global_norm, adamw)`` state (its ``ScaleByAdamState``
``count``/``mu``/``nu``) become the port's ``{"count", "mu", "nu"}`` dict
(lm.py), and back, so a JAX run can continue in the port.  The int8
matmul (``matmul_dtype="int8"``), ``remat`` and the chunked head
(``loss_impl="chunked"``) have no parameters or optimizer state of their
own: they are ways of computing the same model, so these converters carry
a run that uses them as they are.

VGG, unlike the transformer, crosses with a transpose: the JAX package's
conv kernels are HWIO over NHWC activations, the port's OIHW in
``channels_last`` memory format over NCHW ``channels_last`` activations
(models/vgg.py), so ``from_jax_vgg`` / ``to_jax_vgg`` permute every 4-D
conv kernel (the physical order stays HWIO-like, ``channels_last``); BN
scale/bias, running mean/var and the fc head ((in, out), as in the JAX
package) cross as they are.  The VGG trainer's optimizer state crosses too:
the momentum trace of an optax ``chain(add_decayed_weights, sgd(momentum))``
state becomes the port's momentum buffers (``from_jax_sgd_state``), and
back.  A JAX mesh run keeps per-replica state with a leading device axis:
the BN running state (``from_jax_replica_state``) and a stateful
strategy's residual (``from_jax_sync_state``) give one rank its row, so a
port gang starts from the point of a JAX mesh run.
"""

from __future__ import annotations

import re
from functools import partial

import numpy as np
import torch

from .utils.device import resolve_device

_LAYER = re.compile(r"layer(\d+)$")


def _flat_name(path: list[str]) -> str:
    head = _LAYER.match(path[0])
    parts = ["layers", head.group(1)] if head else [path[0]]
    return ".".join(parts + path[1:])


def from_jax_params(tree, device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """Nested dict of arrays (numpy, or anything ``np.asarray`` takes) ->
    flat ``dict[str, Tensor]`` on ``device``, cast to ``dtype`` if given."""
    dev = resolve_device(device)
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
            return
        t = torch.from_numpy(np.array(node, copy=True))
        out[_flat_name(path)] = t.to(device=dev, dtype=dtype or t.dtype)

    walk(tree, [])
    return out


def from_jax_cache(tree, device: str | torch.device = "cuda"
                   ) -> dict[str, dict[str, torch.Tensor]]:
    """A JAX KV cache or page pool ``{"layer{i}": {"k", "v"[, "ks",
    "vs"]}}`` of arrays -> the port's cache dict of tensors on ``device``
    (same names, layouts and dtypes; copied, so the port may update it in
    place)."""
    dev = resolve_device(device)
    return {name: {leaf: torch.from_numpy(np.array(a, copy=True)).to(dev)
                   for leaf, a in layer.items()}
            for name, layer in tree.items()}


def to_jax_params(params: dict[str, torch.Tensor]) -> dict:
    """Flat port parameters -> the JAX package's nested tree of numpy
    arrays (bfloat16 tensors come back as float32: numpy has no bf16)."""
    tree: dict = {}
    for name, t in params.items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer{parts[1]}"] + parts[2:]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node[parts[-1]] = t.numpy()
    return tree


def from_jax_lm_sharded(tree, dims: dict, rank: int, n_data: int,
                        device: str | torch.device = "cuda"
                        ) -> dict[str, torch.Tensor]:
    """One rank's ZeRO-3 shards of the JAX package's whole LM params (or
    Adam moments): ``dims`` maps each port name to its sharded dim or None
    (``lm.param_specs`` through ``lm.fsdp_dim``); rank ``rank`` holds slice
    ``rank % n_data`` of each sharded leaf (the mesh lays the slices out
    dcn-major), and every replicated leaf whole."""
    out = {}
    for name, t in from_jax_params(tree, device=device).items():
        dim = dims[name]
        if dim is not None:
            m = t.shape[dim] // n_data
            t = t.narrow(dim, (rank % n_data) * m, m).clone()
        out[name] = t
    return out


def to_jax_lm_gathered(shards: list[dict], dims: dict) -> dict:
    """``from_jax_lm_sharded``'s inverse over a gang: the shards of one
    slice's ranks (``shards[i]`` the flat dict of arrays or tensors of data
    index i) concatenated along each leaf's sharded dim, back into the JAX
    package's nested tree of numpy arrays; a replicated leaf is the first
    rank's."""
    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)

    whole = {}
    for name, dim in dims.items():
        parts = [host(s[name]) for s in shards]
        whole[name] = parts[0] if dim is None else np.concatenate(parts,
                                                                  axis=dim)
    return to_jax_params({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in whole.items()})


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_jax_window_row(tree, slice_idx: int, dims: dict, rank: int,
                        n_data: int, device: str | torch.device = "cuda"
                        ) -> dict[str, torch.Tensor]:
    """One rank's share of the JAX LM trainer's ``dcn``-stacked window
    state (the delta, or an Adam moment, each leaf with a leading slice
    axis): row ``slice_idx`` (the rank's slice, ``rank // n_data``), then
    the rank's ZeRO-3 shard of it (``from_jax_lm_sharded``)."""
    row = _map_leaves(tree, lambda a: np.asarray(a)[slice_idx])
    return from_jax_lm_sharded(row, dims, rank, n_data, device=device)


def to_jax_window_stacked(shards: list[dict], dims: dict,
                          n_dcn: int) -> dict:
    """``from_jax_window_row``'s inverse over a gang: ``shards[r]`` is rank
    r's flat dict (ranks in order, slices outermost); each slice's ranks
    are gathered (``to_jax_lm_gathered``) and the slices stacked on a
    leading axis, JAX's layout of the window state."""
    n_data = len(shards) // n_dcn
    rows = [to_jax_lm_gathered(shards[s * n_data:(s + 1) * n_data], dims)
            for s in range(n_dcn)]

    def stack(*leaves):
        return np.stack(leaves)

    def walk(nodes):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes]) for k in nodes[0]}
        return stack(*nodes)

    return walk(rows)


def _is_adam_state(node) -> bool:
    return getattr(node, "_fields", None) == ("count", "mu", "nu")


def from_jax_opt_state(state, device: str | torch.device = "cuda") -> dict:
    """An optax state tree (nested tuples of namedtuples, numpy or JAX
    leaves) -> the port's Adam state ``{"count": int, "mu": flat params,
    "nu": flat params}`` from its one ``ScaleByAdamState``."""
    found = []

    def walk(node):
        if _is_adam_state(node):
            found.append(node)
        elif isinstance(node, tuple):
            for child in node:
                walk(child)

    walk(state)
    if len(found) != 1:
        raise ValueError(f"expected one ScaleByAdamState (count, mu, nu) in "
                         f"the optimizer state, found {len(found)}")
    adam = found[0]
    return {"count": int(np.asarray(adam.count)),
            "mu": from_jax_params(adam.mu, device=device),
            "nu": from_jax_params(adam.nu, device=device)}


def to_jax_opt_state(opt_state: dict, like):
    """The port's Adam state -> an optax state of ``like``'s structure
    (numpy leaves): its ``ScaleByAdamState`` takes the count and moments,
    and every other state that carries only a step ``count`` (the LR
    schedule's) takes the count."""
    count = np.asarray(opt_state["count"], dtype=np.int32)

    def walk(node):
        if _is_adam_state(node):
            return node._replace(count=count,
                                 mu=to_jax_params(opt_state["mu"]),
                                 nu=to_jax_params(opt_state["nu"]))
        if getattr(node, "_fields", None) == ("count",):
            return node._replace(count=count)
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return tuple(walk(child) for child in node)
        return node

    return walk(like)


# -- VGG (models/vgg.py, train.py) -----------------------------------------

def _from_jax_leaf(name: str, a, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    if name == "kernel" and t.ndim == 4:  # HWIO -> OIHW, channels_last
        t = t.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
    return t.to(dev)


def _to_jax_leaf(name: str, t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().float()
    if name == "kernel" and t.ndim == 4:  # OIHW -> HWIO
        t = t.permute(2, 3, 1, 0)
    return np.array(t.numpy(), order="C", copy=True)


def _vgg_tree(tree, leaf) -> dict:
    return {layer: {name: leaf(name, a) for name, a in leaves.items()}
            for layer, leaves in tree.items()}


def from_jax_vgg(params, state, device: str | torch.device = "cuda"
                 ) -> tuple[dict, dict]:
    """The JAX package's VGG ``(params, state)`` trees (numpy or JAX leaves)
    -> the port's nested float32 dicts on ``device``, conv kernels HWIO ->
    OIHW (channels_last)."""
    leaf = partial(_from_jax_leaf, dev=resolve_device(device))
    return _vgg_tree(params, leaf), _vgg_tree(state, leaf)


def to_jax_vgg(params: dict, state: dict) -> tuple[dict, dict]:
    """The port's VGG ``(params, state)`` -> the JAX package's trees of numpy
    float32 arrays, conv kernels OIHW -> HWIO."""
    return _vgg_tree(params, _to_jax_leaf), _vgg_tree(state, _to_jax_leaf)


def _is_trace_state(node) -> bool:
    return getattr(node, "_fields", None) == ("trace",)


def from_jax_sgd_state(opt_state, device: str | torch.device = "cuda"
                       ) -> dict:
    """An optax ``chain(add_decayed_weights, sgd(lr, momentum))`` state ->
    the port's momentum buffers, a nested dict shaped like the VGG params
    (conv buffers OIHW, channels_last), from its one ``TraceState``."""
    found = []

    def walk(node):
        if _is_trace_state(node):
            found.append(node)
        elif isinstance(node, tuple):
            for child in node:
                walk(child)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one TraceState (the momentum trace) in "
                         f"the optimizer state, found {len(found)}")
    return _vgg_tree(found[0].trace,
                     partial(_from_jax_leaf, dev=resolve_device(device)))


def to_jax_sgd_state(momentum: dict, like):
    """The port's momentum buffers -> an optax state of ``like``'s structure
    (numpy leaves), its ``TraceState`` taking the buffers."""
    trace = _vgg_tree(momentum, _to_jax_leaf)

    def walk(node):
        if _is_trace_state(node):
            return node._replace(trace=trace)
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return tuple(walk(child) for child in node)
        return node

    return walk(like)


def from_jax_replica_state(state, rank: int,
                           device: str | torch.device = "cuda") -> dict:
    """Rank ``rank``'s BN running state from a JAX mesh trainer's
    replica-stacked state tree (every leaf with a leading device axis):
    row ``rank`` of each leaf, as the port's nested float32 dict."""
    dev = resolve_device(device)
    return _vgg_tree(state, lambda name, a: _from_jax_leaf(
        name, np.asarray(a)[rank], dev))


def from_jax_sync_state(sync_state, rank: int,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """Rank ``rank``'s residual (a float32 vector) from a JAX mesh trainer's
    (n_replicas, L) ``sync_state``, for ``Trainer.load_state``."""
    row = np.array(np.asarray(sync_state)[rank], dtype=np.float32,
                   copy=True)
    return torch.from_numpy(row).to(resolve_device(device))


def from_jax_replica_sgd_state(opt_state, rank: int,
                               device: str | torch.device = "cuda") -> dict:
    """Rank ``rank``'s momentum buffers from a windowed JAX mesh trainer's
    optimizer state, whose leaves carry a leading device axis (each
    replica's own momentum across windows): ``from_jax_sgd_state`` on row
    ``rank``.  The VGG ``sync_state`` row (``from_jax_sync_state``) crosses
    with its outer-momentum tail as it is: the port keeps it raveled in
    the JAX layout."""
    def walk(node):
        if _is_trace_state(node):
            return node._replace(trace=_map_leaves(
                node.trace, lambda a: np.asarray(a)[rank]))
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return tuple(walk(child) for child in node)
        return node

    return from_jax_sgd_state(walk(opt_state), device=device)
