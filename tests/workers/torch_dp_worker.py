"""One rank of a CPU Gloo gang for the PyTorch port's data-parallel tests.

    python torch_dp_worker.py <mode> <in.npz> <out_dir>

with TORCH_DP_RANK, TORCH_DP_WORLD and TORCH_DP_STORE (a FileStore path, so
that no TCP port is fixed) in the environment.  It imports torch, numpy and
the port only, pins torch to one intra-op thread, runs every case of
``mode`` and writes ``<out_dir>/rank<r>.npz``:

- ``strategies``: every registry strategy (and the ring at 4 bits, and
  small-bucket variants) on this rank's row of the input gradients, given
  in the JAX package's tree order and layout; ``quantized_ring_ef`` two
  rounds carrying its residual; ``hierarchical`` over a 2 x 2 mesh, and
  with ``dcn_compress`` int8 and int4 two rounds carrying its residual;
- ``train``: the port's Trainer over the gang from the JAX trainer's
  initial params, one case a config of ``cases.json``: this rank's losses,
  params (JAX layout), BN state, momentum and sync state after the steps
  (``images`` of shape (steps, global batch, ...) give a batch a step);
- ``syncbn``: one sync-BN forward and backward on this rank's shard, the
  gradients meaned over the ranks, and the new BN state;
- ``checks``: ``check_consistency`` after steps and after rank 1 perturbs
  a param, and the augmentation each rank draws for the same batch;
- ``eval``: ``evaluate_sharded`` of seeded TINY params over the gang, and
  its refusal of a batch the ranks do not divide;
- ``lm``: the port's ``LMTrainer(dp=world)`` from the JAX trainer's
  initial params, one case a config of ``cases.json`` (the sync knobs
  included), on this rank's contiguous rows of the global batch: the
  losses, the whole params after the steps (gathered), this rank's shards
  at construction and after the steps, its residual, and ``evaluate`` on
  this rank's rows of the eval batches (a case with ``telemetry`` streams
  into that run directory); and an ``LMTrainer`` whose ``dp`` is not the
  world size, refused;
- ``lm_sync``: the LM two-level sync on this rank's row of the input
  gradients over a 2 x 2 mesh, per case of ``cases.json`` (bucket size
  and compression), two rounds carrying the residual;
- ``window``: ``Hierarchical.local_sync`` and ``window_exchange`` over a
  2 x 2 mesh, per case of ``cases.json`` (compression, bucket size), the
  exchange two rounds carrying the residual;
- ``counts``: the collectives each case's trainer issues over a run, a
  process group at a time (``CallCounter``);
- ``ledger``: the per-slice windows' masked exchange against the
  all-participants exchange on a zeroed delta (``lm_ledger``);
- ``ckpt``: checkpoints over the gang (``lm_ckpt``).  At world size 4:
  ``LMTrainer(dp=4)`` with ZeRO-3 ``fsdp`` and with sync windows (``dcn_size
  2, sync_every 2``), 2 steps, saved in both formats, restored into fresh
  trainers (each rank's pieces compared bitwise) and 2 more steps from
  each, beside the uninterrupted run's; the whole arrays at the save; and
  a VGG ``all_reduce`` step saved by ``Checkpointer`` (BN state, each
  rank's own, stacked over the ranks).  At world size 2: the 4-rank ZeRO-3 checkpoints restored into
  ``LMTrainer(dp=2, fsdp=True)`` (``load_resharded``), the whole arrays and
  the reshard's accounting;
- ``elastic``: the elastic slice at world size 2 (``lm_elastic``): an LM
  window over 2 slices rebuilt from ``sync_every`` 2 to 4 mid-window (rank
  1's delta poisoned first: the rebuild drops it), each rank's Adam row
  before and after, and a fresh trainer given the carried state; a flat
  ``dp=2`` trainer rebuilt to ``fsdp`` beside a fresh ZeRO-3 trainer
  restored from the per-shard checkpoint taken at the rebuild step; a VGG
  ``ddp`` window rebuilt from H 2 to 4 (each rank's momentum and BN state
  before and after); ``DrainGuard.sync`` before and after rank 1 alone
  gets a SIGTERM; ``resize_mesh`` over a (1, 2) mesh and its refusals.

- ``tp``: tensor and sequence parallelism (``lm_tp``) at world size 2 or
  4: ``ring_attention`` over a real ``GroupRing`` for the 2-rank (and at
  4, the 4-rank) seq groups, both layouts (this rank's chunk of the given
  q/k/v, its output and the gradients of a given cotangent); one
  ``LMTrainer`` a ``cases.json`` config of the world size from the given
  whole params (an MoE case's from its own, its ``model`` key the
  model's overrides) (its losses, gathered params, ``evaluate`` and last
  metrics); at world size 4 also ``apply`` with ``tp_axis`` over 2-rank
  model groups on this rank's shards (logits and the shards'
  gradients; the int8 logits), the tensor-parallel chunked head over
  them, and a tp=2 x
  dp=2 trainer's whole-tree and sharded checkpoints restored into fresh
  trainers (bitwise) and stepped on.

``python torch_dp_worker.py lm_cli <out_dir> <lm_cli argv...>`` is no gang
rank of its own: it runs ``lm_cli.run(argv)`` (the launcher's environment
rendezvouses it) and appends a line a step to
``<out_dir>/steps_r<RANK>_g<RESTART_ATTEMPT>.jsonl``: the step, the loss
(a float's hex) and a digest of each token row of the rank's batch;
``TORCH_ELASTIC_STEP_SLEEP`` seconds of sleep after each step pace it.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from distributed_pytorch_tpu_torch import convert  # noqa: E402
from distributed_pytorch_tpu_torch import train as ttrain  # noqa: E402
from distributed_pytorch_tpu_torch.data import augment as taug  # noqa: E402
from distributed_pytorch_tpu_torch.parallel import strategies as st  # noqa: E402,E501
from distributed_pytorch_tpu_torch.utils import debug as dbg  # noqa: E402


def _rows(data, prefix: str, rank: int) -> list[torch.Tensor]:
    keys = sorted((k for k in data.files if k.startswith(prefix)),
                  key=lambda k: int(k[len(prefix):]))
    return [torch.from_numpy(np.array(data[k][rank])) for k in keys]


def strategies(data, rank: int, world: int) -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    flat = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    out = {}

    def save(name, tensors):
        for i, t in enumerate(tensors):
            out[f"{name}/{i}"] = t.numpy()

    cases = {name: (st.get(name), flat) for name in (
        "none", "all_reduce", "gather_scatter", "gather_scatter_symmetric",
        "ddp", "bucketed", "quantized", "quantized_ring")}
    cases["bucketed_small"] = (st.Bucketed(bucket_mb=0.002), flat)
    cases["quantized_ring4"] = (st.QuantizedRing(bits=4), flat)
    cases["quantized_ring_small"] = (st.QuantizedRing(bucket_mb=0.002), flat)
    cases["hierarchical"] = (st.get("hierarchical"), init_device_mesh(
        "cpu", (2, world // 2), mesh_dim_names=("dcn", "ici")))
    for name, (strategy, mesh) in cases.items():
        save(name, strategy(_rows(data, "g", rank), mesh))
    stateful = {"quantized_ring_ef": (st.get("quantized_ring_ef"), flat)}
    for bits in ("int8", "int4"):
        stateful[f"hierarchical_{bits}"] = (
            st.Hierarchical(dcn_compress=bits, dcn_size=2),
            cases["hierarchical"][1])
    for name, (strategy, mesh) in stateful.items():
        res = strategy.init_state(_rows(data, "g", rank), world)
        for r, prefix in enumerate(("g", "h")):
            synced, res = strategy(_rows(data, prefix, rank), mesh, res)
            save(f"{name}{r}", synced)
            out[f"{name}{r}/res"] = res.numpy()
    return out


def window(data, rank: int, world: int, cases: dict) -> dict:
    """``Hierarchical``'s window halves over a (2, world // 2) ``("dcn",
    "ici")`` mesh, one case a ``cases.json`` entry: ``local_sync`` on this
    rank's row of ``g``, or ``window_exchange`` on its rows of the
    slice-uniform deltas ``d`` then ``e`` (two rounds carrying the
    residual under ``compress``)."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("dcn", "ici"))
    out = {}
    for name, case in cases.items():
        s = st.Hierarchical(dcn_compress=case["compress"], dcn_size=2,
                            bucket_mb=case["bucket_mb"])
        if case["op"] == "local_sync":
            rounds = [("g", s.local_sync(_rows(data, "g", rank), mesh))]
        else:
            res = s.init_state(_rows(data, "d", rank), world) \
                if case["compress"] else None
            rounds = []
            for prefix in ("d", "e"):
                ex = s.window_exchange(_rows(data, prefix, rank), mesh, res)
                if case["compress"]:
                    ex, res = ex
                    out[f"{name}{len(rounds)}/res"] = res.numpy()
                rounds.append((prefix, ex))
        for r, (_, synced) in enumerate(rounds):
            for i, t in enumerate(synced):
                out[f"{name}{r}/{i}"] = t.numpy()
    return out


def _jax_tree(params: dict, data, prefix: str) -> dict:
    return {k: {n: data[f"{prefix}/{k}/{n}"] for n in v}
            for k, v in params.items()}


def _trainer(data, cfg: dict, rank: int):
    tr = ttrain.Trainer(ttrain.TrainConfig(**cfg), device="cpu")
    params, state = convert.from_jax_vgg(
        _jax_tree(tr.params, data, "p"), _jax_tree(tr.state, data, "s"),
        device="cpu")
    tr.load_state(params, state)
    return tr


def train(data, rank: int, world: int, cases: dict) -> dict:
    images, labels = data["images"], data["labels"]
    per = images.shape[images.ndim - 4] // world
    mine = slice(rank * per, (rank + 1) * per)
    out = {}
    for name, case in cases.items():
        tr = _trainer(data, case["cfg"], rank)
        k = case.get("steps_per_call", 1)
        losses, grad_max = [], []
        before = tr.momentum()
        for c in range(case["steps"] // k):
            if images.ndim == 5:  # a batch a step: (steps, global, ...)
                imgs, lbls = images[c * k:(c + 1) * k, mine], \
                    labels[c * k:(c + 1) * k, mine]
            else:
                imgs, lbls = np.stack([images[mine]] * k), \
                    np.stack([labels[mine]] * k)
            losses += tr.train_steps(imgs, lbls).tolist()
            # the step's synced gradient (plus weight decay) is what the
            # momentum buffer gained: m_t - momentum * m_{t-1}
            after = tr.momentum()
            grad_max.append(max(
                float((after[k1][n] - tr.cfg.momentum * before[k1][n])
                      .abs().max()) for k1 in after for n in after[k1]))
            before = after
        out[f"{name}/grad_max"] = np.asarray(grad_max)
        params, state = convert.to_jax_vgg(tr.params, tr.state)
        momentum, _ = convert.to_jax_vgg(tr.momentum(), {})
        out[f"{name}/losses"] = np.asarray(losses)
        out[f"{name}/sync_state"] = tr.sync_state.numpy()
        for tag, tree in (("p", params), ("s", state), ("m", momentum)):
            for k1, v in tree.items():
                for n, a in v.items():
                    out[f"{name}/{tag}/{k1}/{n}"] = a
    return out


def syncbn(data, rank: int, world: int) -> dict:
    cfg = ttrain.TrainConfig(model="TINY", strategy="ddp", sync_bn=True,
                             augment=False, batch_size=4)
    tr = _trainer(data, vars(cfg), rank)
    per = data["images"].shape[0] // world
    mine = slice(rank * per, (rank + 1) * per)
    loss, new_state = ttrain._loss_fn(
        tr.params, tr.state, None, torch.from_numpy(data["images"][mine]),
        torch.from_numpy(data["labels"][mine]).long(), cfg=cfg,
        bn_axis=dist.group.WORLD)
    loss.backward()
    leaves = [tr.params[k][n] for k, n in ttrain.jax_order(tr.params)]
    ttrain.sync_grads(tr.strategy, tr.mesh, [p.grad for p in leaves])
    out = {"loss": loss.detach().numpy()}
    for (k, n), p in zip(ttrain.jax_order(tr.params), leaves):
        out[f"grad/{k}/{n}"] = p.grad.numpy()
    for k, v in new_state.items():
        for n, t in v.items():
            out[f"state/{k}/{n}"] = t.numpy()
    return out


def checks(data, rank: int, world: int) -> dict:
    images, labels = data["images"], data["labels"]
    per = images.shape[0] // world
    mine = slice(rank * per, (rank + 1) * per)
    tr = _trainer(data, {"model": "TINY", "strategy": "ddp",
                         "batch_size": per, "augment": True}, rank)
    drawn = []
    real = taug.augment

    def recording(gen, imgs):
        x = real(gen, imgs)
        drawn.append(x.detach().clone())
        return x

    taug.augment = recording
    # the same images on every rank: only the rank's draws differ
    tr.train_steps(np.stack([images[:per]] * 2), np.stack([labels[:per]] * 2))
    taug.augment = real
    tr.train_step(images[mine], labels[mine])
    out = {"crops0": drawn[0].numpy(), "crops1": drawn[1].numpy()}
    tr.check_consistency()
    out["consistent_after_steps"] = np.asarray(True)
    if rank == 1:
        with torch.no_grad():
            tr.params["fc"]["bias"][0] += 1e-3
    try:
        tr.check_consistency()
        out["raised_after_perturbation"] = np.asarray(False)
    except dbg.ConsistencyError as e:
        out["raised_after_perturbation"] = np.asarray(True)
        out["message"] = np.asarray(str(e))
    return out


def sharded_eval(data, rank: int, world: int) -> dict:
    from distributed_pytorch_tpu_torch import eval as teval
    from distributed_pytorch_tpu_torch.data import cifar10
    from distributed_pytorch_tpu_torch.models import vgg
    params, state = vgg.init(3, "TINY", device="cpu")
    ds = cifar10._synthetic(int(data["n"]), seed=3)
    group = dist.group.WORLD
    out = {}
    for fold in (False, True):
        out[f"fold{int(fold)}"] = np.asarray(teval.evaluate_sharded(
            params, state, ds, group, batch_size=int(data["batch"]),
            model_name="TINY", fold_bn=fold, log=None, device="cpu"))
    try:
        teval.evaluate_sharded(params, state, ds, group,
                               batch_size=world + 2, model_name="TINY",
                               log=None, device="cpu")
        out["refused"] = np.asarray("")
    except ValueError as e:
        out["refused"] = np.asarray(str(e))
    return out


def lm(data, rank: int, world: int, cases: dict) -> dict:
    from distributed_pytorch_tpu_torch.utils import telemetry
    out = {}
    for name, case in cases.items():
        if case.get("telemetry"):
            telemetry.enable(case["telemetry"], rank=rank)
        try:
            _lm_case(data, rank, world, name, case, out)
        finally:
            telemetry.disable()
    return _lm_refusal(world, out)


def _lm_case(data, rank: int, world: int, name: str, case: dict,
             out: dict) -> None:
    from distributed_pytorch_tpu_torch import lm as tlm
    from distributed_pytorch_tpu_torch.models import transformer as ttfm
    init = {k[len("p/"):]: data[k] for k in data.files
            if k.startswith("p/")}
    tokens, targets = data["tokens"], data["targets"]
    per = tokens.shape[0] // world
    mine = slice(rank * per, (rank + 1) * per)
    cfg = tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**case["model"]),
        compute_dtype=None, dp=world, **case.get("cfg", {}))
    tr = tlm.LMTrainer(cfg, device="cpu")
    tr.load_state({k: torch.from_numpy(np.array(v))
                   for k, v in init.items()})
    for k, v in tr.params.items():
        out[f"{name}/shard0/{k}"] = v.detach().numpy().copy()
    losses, mets = [], []
    for _ in range(case["steps"]):
        losses.append(float(tr.train_step(tokens[mine], targets[mine])))
        mets.append(tr.last_metrics.numpy())
    out[f"{name}/losses"] = np.asarray(losses)
    out[f"{name}/met"] = np.stack(mets)
    for tag in ("delta", "outer_m"):
        for k, v in (getattr(tr, f"_{tag}") or {}).items():
            out[f"{name}/{tag}/{k}"] = v.numpy()
    for k, v in tr.full_params().items():
        out[f"{name}/p/{k}"] = v.numpy()
    for k, v in tr.params.items():
        out[f"{name}/shard/{k}"] = v.detach().numpy()
    for m in ("mu", "nu"):
        for k, v in tr.opt_state[m].items():
            out[f"{name}/{m}/{k}"] = v.numpy()
    out[f"{name}/sync_state"] = tr.sync_state.numpy()
    ev = tr.evaluate([(tokens[mine], targets[mine])])
    out[f"{name}/eval"] = np.asarray([ev["loss"], ev["tokens"]])


def _lm_refusal(world: int, out: dict) -> dict:
    from distributed_pytorch_tpu_torch import lm as tlm
    try:
        tlm.LMTrainer(tlm.LMTrainConfig(dp=world + 1), device="cpu")
        out["refused"] = np.asarray("")
    except NotImplementedError as e:
        out["refused"] = np.asarray(str(e))
    return out


def lm_sync(data, rank: int, world: int, cases: dict) -> dict:
    """The LM two-level sync (``lm.LMSync.two_level``) on this rank's row
    of the input gradients over the (2, world // 2) ``("dcn", "data")``
    mesh, one case a (bucket bytes, compress) pair of ``cases.json``, two
    rounds carrying the residual."""
    from distributed_pytorch_tpu_torch import lm as tlm
    shapes = {k[len("shape/"):]: tuple(int(d) for d in data[k])
              for k in data.files if k.startswith("shape/")}
    cfg = tlm.LMTrainConfig(dp=world, dcn_size=2, fsdp=True)
    sync = tlm.LMSync(cfg, tlm.make_lm_mesh(cfg, device="cpu"), shapes)
    names = sync.names
    out = {}
    for name, case in cases.items():
        bb, compress = case["bucket_bytes"], case["compress"]
        res = None
        if compress is not None:
            sizes = [int(np.prod(data[f"g/{n}"].shape[1:])) for n in names]
            res = torch.zeros(tlm._residual_total_len(
                sizes, [sync.specs[n] for n in names], 2, world // 2, bb))
        for r, prefix in enumerate(("g", "h")):
            grads = [torch.from_numpy(np.array(data[f"{prefix}/{n}"][rank]))
                     for n in names]
            synced, res = sync.two_level(grads, names, bb, compress, res)
            for n, t in zip(names, synced):
                out[f"{name}{r}/{n}"] = t.numpy()
            out[f"{name}{r}/res"] = res.numpy()
    return out


def lm_ledger(data, rank: int, world: int, cases: dict) -> dict:
    """Per case (an LM config with ``sync_every_per_slice`` and
    ``dcn_compress``): train ``steps`` steps from the input params, then
    run the window's exchange twice from copies of the state: masked
    ([1, 0]: slice 1 skips) and with every slice in but slice 1's delta
    zeroed.  Writes both anchors, residuals and deltas, and the live
    delta."""
    from distributed_pytorch_tpu_torch import lm as tlm
    from distributed_pytorch_tpu_torch.models import transformer as ttfm
    init = {k[len("p/"):]: torch.from_numpy(np.array(data[k]))
            for k in data.files if k.startswith("p/")}
    per = data["tokens"].shape[0] // world
    mine = slice(rank * per, (rank + 1) * per)
    out = {}

    def copy(tree):
        return {k: v.detach().clone() for k, v in tree.items()}

    for name, case in cases.items():
        cfg = tlm.LMTrainConfig(
            model=ttfm.TransformerConfig(**case["model"]),
            compute_dtype=None, dp=world, **case["cfg"])
        tr = tlm.LMTrainer(cfg, device="cpu")
        tr.load_state(init)
        for _ in range(case["steps"]):
            tr.train_step(data["tokens"][mine], data["targets"][mine])
        w = tr.window
        runs = {}
        for tag, mask in (("masked", [1.0, 0.0]), ("manual", [1.0, 1.0])):
            anchor, delta = copy(tr.params), copy(tr._delta)
            if tag == "manual" and w.slice == 1:
                for x in delta.values():
                    x.zero_()
            res, _ = w.exchange(anchor, delta, tr.sync_state.clone(), None,
                                mask)
            runs[tag] = (anchor, delta, res)
        for tag, (anchor, delta, res) in runs.items():
            out[f"{name}/{tag}/res"] = res.numpy()
            for k in anchor:
                out[f"{name}/{tag}/anchor/{k}"] = anchor[k].numpy()
                out[f"{name}/{tag}/delta/{k}"] = delta[k].numpy()
        out[f"{name}/res_before"] = tr.sync_state.numpy()
        for k, v in tr._delta.items():
            out[f"{name}/live/{k}"] = v.numpy()
    return out


class CallCounter:
    """Counts the ``torch.distributed`` collectives issued while active, a
    group at a time: ``calls[group]`` and ``bytes[group]`` (what the rank
    sends into each call: the all-reduced, broadcast or scattered tensor,
    the all-gathered shard, the ring's sends), ``group`` the comma-joined
    global ranks of the group."""

    # name -> the index of the tensor whose bytes the call sends
    FNS = {"all_reduce": 0, "broadcast": 0, "all_gather_into_tensor": 1,
           "all_gather_single": 1, "reduce_scatter_tensor": 1,
           "reduce_scatter_single": 1, "all_gather": 1, "gather": 0,
           "scatter": 1, "batch_isend_irecv": None}

    def __init__(self):
        self.calls: dict = {}
        self.bytes: dict = {}
        self._saved: list = []

    @staticmethod
    def _key(group) -> str:
        if group is None:
            group = dist.group.WORLD
        return ",".join(str(r) for r in dist.get_process_group_ranks(group))

    def _record(self, name, args, kwargs):
        if name == "batch_isend_irecv":
            ops = args[0]
            key = self._key(ops[0].group) if ops else ""
            nbytes = sum(o.tensor.numel() * o.tensor.element_size()
                         for o in ops if o.op is dist.isend)
        else:
            key = self._key(kwargs.get("group"))
            t = args[self.FNS[name]] if len(args) > self.FNS[name] else \
                kwargs.get("tensor", kwargs.get("input"))
            if isinstance(t, (list, tuple)):
                t = t[0] if t else None
            nbytes = 0 if t is None else t.numel() * t.element_size()
        self.calls[key] = self.calls.get(key, 0) + 1
        self.bytes[key] = self.bytes.get(key, 0) + nbytes

    def _wrap(self, name, fn):
        def counted(*args, **kwargs):
            self._record(name, args, kwargs)
            return fn(*args, **kwargs)
        return counted

    def __enter__(self):
        seen = {}
        for name in self.FNS:
            fn = getattr(dist, name, None)
            if fn is not None:
                seen[id(fn)] = name
                self._saved.append((dist, name, fn))
                setattr(dist, name, self._wrap(name, fn))
        for attr in ("all_gather_flat", "reduce_scatter_flat"):
            fn = getattr(st, attr)
            self._saved.append((st, attr, fn))
            setattr(st, attr, self._wrap(seen[id(fn)], fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()


def lm_ckpt(data, rank: int, world: int, cases: dict) -> dict:
    from distributed_pytorch_tpu_torch import lm as tlm
    from distributed_pytorch_tpu_torch.models import transformer as ttfm
    model = ttfm.TransformerConfig(**cases["model"])
    tokens, targets = data["tokens"], data["targets"]
    base = cases["dir"]
    out = {}

    def rows(i):
        per = tokens.shape[1] // world
        mine = slice(rank * per, (rank + 1) * per)
        return tokens[i, mine], targets[i, mine]

    def local(tr) -> dict:
        return {f"{m}/{n}": t.detach().clone() for m, tree in (
            ("p", tr.params), ("mu", tr.opt_state["mu"]),
            ("nu", tr.opt_state["nu"])) for n, t in tree.items()}

    def whole(tr, tag):
        stacked = tr.window is not None
        for m, tree in (("p", tr._whole(tr.params, False)),
                        ("mu", tr._whole(tr.opt_state["mu"], stacked)),
                        ("nu", tr._whole(tr.opt_state["nu"], stacked))):
            for n, t in tree.items():
                out[f"{tag}/{m}/{n}"] = t.numpy()

    if world == 2:  # the 4-rank ZeRO-3 checkpoints onto two ranks
        cfg = tlm.LMTrainConfig(model=model, compute_dtype=None, dp=2,
                                fsdp=True)
        for fmt in ("sharded", "whole"):
            tr = tlm.LMTrainer(cfg, device="cpu")
            out[f"re/{fmt}/step"] = np.asarray(
                tr.maybe_restore(os.path.join(base, f"fsdp_{fmt}")))
            whole(tr, f"re/{fmt}")
            if fmt == "sharded":
                for k, v in tr._ckptr.last_reshard_stats.items():
                    out[f"re/stats/{k}"] = np.asarray(v)
        return out
    for name, kw in (("fsdp", dict(fsdp=True)),
                     ("window", dict(dcn_size=2, sync_every=2))):
        cfg = tlm.LMTrainConfig(model=model, compute_dtype=None, dp=world,
                                **kw)
        tr = tlm.LMTrainer(cfg, device="cpu")
        for i in range(2):
            tr.train_step(*rows(i))
        dirs = {fmt: os.path.join(base, f"{name}_{fmt}")
                for fmt in ("sharded", "whole")}
        tr.save_checkpoint(dirs["sharded"], sharded=True)
        tr.save_checkpoint(dirs["whole"], extra_meta={"at": 2})
        tr.flush_checkpoints()
        saved = local(tr)
        whole(tr, name)
        out[f"{name}/cont"] = np.asarray(
            [float(tr.train_step(*rows(i))) for i in (2, 3)])
        for fmt, d in dirs.items():
            fresh = tlm.LMTrainer(cfg, device="cpu")
            out[f"{name}/{fmt}/step"] = np.asarray(fresh.maybe_restore(d))
            got = local(fresh)
            out[f"{name}/{fmt}/equal"] = np.asarray(
                got.keys() == saved.keys() and all(
                    torch.equal(v, saved[k]) for k, v in got.items()))
            out[f"{name}/{fmt}/losses"] = np.asarray(
                [float(fresh.train_step(*rows(i))) for i in (2, 3)])
    from distributed_pytorch_tpu_torch.utils import checkpoint as tck
    # all_reduce: no buffer broadcast, so each rank keeps its own BN stats
    tr = ttrain.Trainer(ttrain.TrainConfig(model="TINY",
                                           strategy="all_reduce",
                                           batch_size=2, augment=False),
                        device="cpu")
    images, labels = data["images"], data["labels"]
    per = images.shape[0] // world
    tr.train_step(images[rank * per:(rank + 1) * per],
                  labels[rank * per:(rank + 1) * per])
    tck.Checkpointer(os.path.join(base, "vgg")).save(tr, 1)
    for tag, tree in (("p", tr.params), ("s", tr.state)):
        for k1, v in tree.items():
            for n, t in v.items():
                out[f"vgg/{tag}/{k1}/{n}"] = t.detach().numpy()
    return out


def lm_tp(data, rank: int, world: int, cases: dict) -> dict:
    from distributed_pytorch_tpu_torch import lm as tlm
    from distributed_pytorch_tpu_torch.models import transformer as ttfm
    from distributed_pytorch_tpu_torch.ops import losses as tlosses
    from distributed_pytorch_tpu_torch.parallel import context as tctx
    out = {}
    # every rank makes every group, in one order; at world size 2 the
    # world is the one pair
    world_group = dist.new_group(list(range(world)))
    if world == 4:
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        pair = pairs[rank // 2]
    else:
        pair = world_group

    # -- the ring: each rank's chunk of the whole q/k/v ---------------------
    q, k, v, g = (torch.from_numpy(np.array(data[f"ring/{x}"]))
                  for x in ("q", "k", "v", "g"))
    s = q.shape[2]
    for n, group in ((2, pair), (4, world_group))[:world // 2]:
        me = rank % n
        for layout in ("contiguous", "zigzag"):
            perm = tctx.zigzag_permutation(n, s) if layout == "zigzag" \
                else np.arange(s)
            c = s // n
            mine = torch.as_tensor(perm[me * c:(me + 1) * c])
            qc, kc, vc = (x[:, :, mine].clone().requires_grad_(True)
                          for x in (q, k, v))
            o = tctx.ring_attention(qc, kc, vc, group, layout=layout,
                                    impl="flash")
            (o * g[:, :, mine]).sum().backward()
            tag = f"ring/{n}/{layout}"
            for name, t in (("o", o), ("dq", qc.grad), ("dk", kc.grad),
                            ("dv", vc.grad)):
                out[f"{tag}/{name}"] = t.detach().numpy()

    model = ttfm.TransformerConfig(**cases["model"])

    def params(prefix):
        return {k[len(prefix):]: torch.from_numpy(np.array(data[k]))
                for k in data.files if k.startswith(prefix)}

    whole = params("p/")
    tokens, targets = data["tokens"], data["targets"]

    def rows(tr, i):
        per = tokens.shape[1] // tr.cfg.dp
        d = tr.place.data_index
        return tokens[i, d * per:(d + 1) * per], \
            targets[i, d * per:(d + 1) * per]

    for name, case in cases["trainer"][str(world)].items():
        case = dict(case)
        mkw = case.pop("model", {})  # an MoE case's model and params
        cfg = tlm.LMTrainConfig(
            model=ttfm.TransformerConfig(**dict(cases["model"], **mkw)),
            compute_dtype=None, **case)
        tr = tlm.LMTrainer(cfg, device="cpu")
        tr.load_state(params("pmoe/") if mkw else whole)
        losses = [float(tr.train_step(*rows(tr, i)))
                  for i in range(cases["steps"])]
        out[f"tr/{name}/losses"] = np.asarray(losses)
        out[f"tr/{name}/met"] = tr.last_metrics.numpy()
        for n2, t in tr.full_params().items():
            out[f"tr/{name}/p/{n2}"] = t.numpy()
        ev = tr.evaluate([rows(tr, 0)])
        out[f"tr/{name}/eval"] = np.asarray([ev["loss"], ev["tokens"]])
    if world != 4:
        return out

    # -- apply and the chunked head over 2-rank model groups ----------------
    specs = ttfm.shard_specs(model)
    m = rank % 2
    shards = {}
    for name, t in whole.items():
        dim = ttfm.tp_dim(specs[name])
        if dim is not None:
            w = t.shape[dim] // 2
            t = t.narrow(dim, m * w, w)
        shards[name] = t.clone().requires_grad_(True)
    toks = torch.from_numpy(np.array(data["apply/tokens"])).long()
    logits = ttfm.apply(shards, toks, cfg=model, tp_axis=pair)
    (logits * torch.from_numpy(np.array(data["apply/g"]))).sum().backward()
    out["apply/logits"] = logits.detach().numpy()
    for name, t in shards.items():
        out[f"apply/grad/{name}"] = t.grad.numpy()
    with torch.no_grad():
        out["apply/int8_logits"] = ttfm.apply(
            shards, toks, cfg=model, tp_axis=pair,
            matmul_dtype="int8").numpy()
    h, emb = (torch.from_numpy(np.array(data[f"head/{x}"]))
              .requires_grad_(True) for x in ("h", "emb"))
    ce, cnt = tlosses.masked_ce_chunked(
        h, emb, torch.from_numpy(np.array(data["head/targets"])).long(),
        chunk=int(data["head/chunk"]), tp_axis=pair, tp_size=2)
    ce.backward()
    out["head/ce"] = ce.detach().numpy()
    out["head/n"] = cnt.numpy()
    out["head/dh"] = h.grad.numpy()
    out["head/demb"] = emb.grad.numpy()

    # -- checkpoints of a tp=2 x dp=2 trainer ------------------------------
    cfg = tlm.LMTrainConfig(model=model, compute_dtype=None, dp=2, tp=2)

    def local(tr) -> dict:
        return {f"{m2}/{n2}": t.detach().clone() for m2, tree in (
            ("p", tr.params), ("mu", tr.opt_state["mu"]),
            ("nu", tr.opt_state["nu"])) for n2, t in tree.items()}

    tr = tlm.LMTrainer(cfg, device="cpu")
    tr.load_state(whole)
    for i in range(2):
        tr.train_step(*rows(tr, i))
    dirs = {fmt: os.path.join(cases["dir"], f"tp_{fmt}")
            for fmt in ("sharded", "whole")}
    tr.save_checkpoint(dirs["sharded"], sharded=True)
    tr.save_checkpoint(dirs["whole"])
    tr.flush_checkpoints()
    saved = local(tr)
    out["ckpt/cont"] = np.asarray([float(tr.train_step(*rows(tr, 2)))])
    for fmt, d in dirs.items():
        fresh = tlm.LMTrainer(cfg, device="cpu")
        out[f"ckpt/{fmt}/step"] = np.asarray(fresh.maybe_restore(d))
        got = local(fresh)
        out[f"ckpt/{fmt}/equal"] = np.asarray(
            got.keys() == saved.keys() and all(
                torch.equal(t, saved[k2]) for k2, t in got.items()))
        out[f"ckpt/{fmt}/cont"] = np.asarray(
            [float(fresh.train_step(*rows(fresh, 2)))])
    return out


def lm_elastic(data, rank: int, world: int, cases: dict) -> dict:
    import signal
    from distributed_pytorch_tpu_torch import lm as tlm
    from distributed_pytorch_tpu_torch.models import transformer as ttfm
    from distributed_pytorch_tpu_torch.parallel import elastic as tel
    from distributed_pytorch_tpu_torch.parallel import mesh as tmesh
    model = ttfm.TransformerConfig(**cases["model"])
    tokens, targets = data["tokens"], data["targets"]
    init = {k[len("init/"):]: torch.from_numpy(np.array(data[k]))
            for k in data.files if k.startswith("init/")}
    out = {}

    def rows(i):
        per = tokens.shape[1] // world
        mine = slice(rank * per, (rank + 1) * per)
        return tokens[i, mine], targets[i, mine]

    def moments(tr, tag):
        for m in ("mu", "nu"):
            for n, t in tr.opt_state[m].items():
                out[f"{tag}/{m}/{n}"] = t.detach().numpy().copy()

    # the LM window: 3 steps (one window and one step into the next),
    # rebuilt to H = 4, 4 more steps
    cfg = tlm.LMTrainConfig(model=model, compute_dtype=None, dp=world,
                            **cases["window"])
    tr = tlm.LMTrainer(cfg, device="cpu")
    tr.load_state(init)
    losses = [float(tr.train_step(*rows(i))) for i in range(3)]
    moments(tr, "win/pre")
    if rank == 1:
        for d in tr._delta.values():
            d.fill_(float("nan"))
    anchor = {n: p.detach().clone() for n, p in tr.params.items()}
    tr.rebuild(sync_every=4)
    out["win/sync_every"] = np.asarray(tr.cfg.sync_every)
    moments(tr, "win/post")
    carried = {"count": tr.opt_state["count"],
               **{m: {n: t.detach().clone() for n, t in tr.opt_state[m]
                      .items()} for m in ("mu", "nu")}}
    losses += [float(tr.train_step(*rows(i))) for i in range(3, 7)]
    out["win/losses"] = np.asarray(losses)
    fresh = tlm.LMTrainer(tlm.LMTrainConfig(
        model=model, compute_dtype=None, dp=world,
        **dict(cases["window"], sync_every=4)), device="cpu")
    fresh.load_state(anchor, carried)
    out["win/fresh"] = np.asarray(
        [float(fresh.train_step(*rows(i))) for i in range(3, 7)])

    # flat dp -> ZeRO-3, against a fresh ZeRO-3 trainer restored from the
    # per-shard checkpoint taken at the rebuild step
    d = os.path.join(cases["dir"], "fsdp")
    tr = tlm.LMTrainer(tlm.LMTrainConfig(model=model, compute_dtype=None,
                                         dp=world), device="cpu")
    tr.load_state(init)
    for i in range(2):
        tr.train_step(*rows(i))
    tr.save_checkpoint(d, sharded=True)
    tr.rebuild(fsdp=True)
    out["fsdp/losses"] = np.asarray(
        [float(tr.train_step(*rows(i))) for i in (2, 3)])
    fresh = tlm.LMTrainer(tlm.LMTrainConfig(
        model=model, compute_dtype=None, dp=world, fsdp=True), device="cpu")
    out["fsdp/step"] = np.asarray(fresh.maybe_restore(d))
    out["fsdp/fresh"] = np.asarray(
        [float(fresh.train_step(*rows(i))) for i in (2, 3)])

    # the VGG ddp window, H 2 -> 4: rank 0's momentum and BN statistics
    vt = ttrain.Trainer(ttrain.TrainConfig(
        model="TINY", strategy="ddp", batch_size=2, augment=False, lr=0.01,
        sync_every=2, max_sync_every=4, steps_per_loop=4), device="cpu")
    images, labels = data["images"], data["labels"]
    per = images.shape[1] // world
    vt.train_steps(images[:, rank * per:(rank + 1) * per],
                   labels[:, rank * per:(rank + 1) * per])
    for tag in ("pre", "post"):
        if tag == "post":
            vt.rebuild(sync_every=4)
            out["vgg/sync_every"] = np.asarray(vt.cfg.sync_every)
        for k1, v in vt.momentum().items():
            for n, t in v.items():
                out[f"vgg/{tag}/m/{k1}/{n}"] = t.numpy().copy()
        for k1, v in vt.state.items():
            for n, t in v.items():
                out[f"vgg/{tag}/s/{k1}/{n}"] = t.detach().numpy().copy()
    out["vgg/after"] = vt.train_steps(
        images[:, rank * per:(rank + 1) * per],
        labels[:, rank * per:(rank + 1) * per]).numpy()

    # the drain agreement: rank 1 alone is signalled
    guard = tel.DrainGuard().install()
    out["drain/before"] = np.asarray(guard.sync())
    if rank == 1:
        os.kill(os.getpid(), signal.SIGTERM)
    out["drain/after"] = np.asarray(guard.sync())
    out["drain/local"] = np.asarray(guard.requested)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)

    # resize_mesh over a (1, 2) mesh
    m = tmesh.make_mesh(world, axis_names=("data", "model"),
                        axis_shape=(1, world), device="cpu")
    r = tmesh.resize_mesh(m, world)
    out["mesh/shape"] = np.asarray(tuple(r.mesh.shape))
    out["mesh/names"] = np.asarray(r.mesh_dim_names)
    for n, exc in ((3, ValueError), (4, NotImplementedError)):
        try:
            tmesh.resize_mesh(m, n)
            out[f"mesh/{n}"] = np.asarray("no error")
        except exc as e:
            out[f"mesh/{n}"] = np.asarray(str(e))
    return out


def lm_cli_child(out_dir: str, argv: list[str]) -> int:
    """``lm_cli.run(argv)``, recording each step (see the module
    docstring)."""
    import hashlib
    import time
    from distributed_pytorch_tpu_torch import lm as tlm
    from distributed_pytorch_tpu_torch import lm_cli
    pause = float(os.environ.get("TORCH_ELASTIC_STEP_SLEEP", "0"))
    path = os.path.join(out_dir, f"steps_r{os.environ.get('RANK', '0')}_g"
                        f"{os.environ.get('RESTART_ATTEMPT', '0')}.jsonl")
    step_fn = tlm.LMTrainer.train_step

    def recorded(self, tokens, targets):
        loss = step_fn(self, tokens, targets)
        rows = [hashlib.sha1(np.ascontiguousarray(r).tobytes()).hexdigest()
                [:16] for r in np.asarray(tokens)]
        with open(path, "a") as f:
            f.write(json.dumps({"step": self._step,
                                "loss": float(loss).hex(),
                                "rows": rows}) + "\n")
        time.sleep(pause)
        return loss
    tlm.LMTrainer.train_step = recorded
    lm_cli.run(argv)
    return 0


def counts(data, rank: int, world: int, cases: dict) -> dict:
    """Each case's collectives by group (``CallCounter``) over its run:
    a VGG ``Trainer`` (``kind`` "vgg": one ``train_steps`` call of
    ``steps`` batches) or an ``LMTrainer`` (``kind`` "lm": ``steps``
    ``train_step`` calls), each built before counting (its construction
    broadcasts the params)."""
    from distributed_pytorch_tpu_torch import lm as tlm
    from distributed_pytorch_tpu_torch.models import transformer as ttfm
    out = {}
    for name, case in cases.items():
        if case["kind"] == "vgg":
            tr = ttrain.Trainer(ttrain.TrainConfig(**case["cfg"]),
                                device="cpu")
            images, labels = data["images"], data["labels"]
            per = images.shape[1] // world
            mine = slice(rank * per, (rank + 1) * per)
            imgs, lbls = images[:case["steps"], mine], \
                labels[:case["steps"], mine]
            with CallCounter() as c:
                tr.train_steps(imgs, lbls)
        else:
            cfg = tlm.LMTrainConfig(
                model=ttfm.TransformerConfig(**case["model"]),
                compute_dtype=None, dp=world, **case.get("cfg", {}))
            tr = tlm.LMTrainer(cfg, device="cpu")
            per = data["tokens"].shape[0] // world
            mine = slice(rank * per, (rank + 1) * per)
            tok, tgt = data["tokens"][mine], data["targets"][mine]
            with CallCounter() as c:
                for _ in range(case["steps"]):
                    tr.train_step(tok, tgt)
        for key in c.calls:
            out[f"{name}/calls/{key}"] = np.asarray(c.calls[key])
            out[f"{name}/bytes/{key}"] = np.asarray(c.bytes[key])
    return out


def main() -> int:
    if sys.argv[1] == "lm_cli":
        return lm_cli_child(sys.argv[2], sys.argv[3:])
    mode, in_path, out_dir = sys.argv[1:4]
    rank = int(os.environ["TORCH_DP_RANK"])
    world = int(os.environ["TORCH_DP_WORLD"])
    store = dist.FileStore(os.environ["TORCH_DP_STORE"], world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    data = np.load(in_path)
    if mode == "strategies":
        out = strategies(data, rank, world)
    elif mode == "train":
        with open(os.path.join(os.path.dirname(in_path), "cases.json")) as f:
            out = train(data, rank, world, json.load(f))
    elif mode == "syncbn":
        out = syncbn(data, rank, world)
    elif mode == "eval":
        out = sharded_eval(data, rank, world)
    elif mode in ("lm", "lm_sync", "counts", "ledger", "window", "ckpt",
                  "elastic", "tp"):
        with open(os.path.join(os.path.dirname(in_path), "cases.json")) as f:
            out = {"lm": lm, "lm_sync": lm_sync, "counts": counts,
                   "ledger": lm_ledger, "window": window,
                   "ckpt": lm_ckpt, "elastic": lm_elastic,
                   "tp": lm_tp}[mode](
                data, rank, world, json.load(f))
    else:
        out = checks(data, rank, world)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    return 0



# -- the launcher side, for the tests -------------------------------------

def run_gang(mode: str, inputs: dict, out_dir: str, world: int = 4,
             cases: dict | None = None, timeout_s: float = 240.0
             ) -> list[dict]:
    """Run ``world`` ranks of ``mode`` on ``inputs`` (arrays) over a
    FileStore in ``out_dir``; returns each rank's outputs."""
    import subprocess
    os.makedirs(out_dir, exist_ok=True)
    in_path = os.path.join(out_dir, "in.npz")
    np.savez(in_path, **inputs)
    if cases is not None:
        with open(os.path.join(out_dir, "cases.json"), "w") as f:
            json.dump(cases, f)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for r in range(world):
        env = dict(os.environ, TORCH_DP_RANK=str(r),
                   TORCH_DP_WORLD=str(world),
                   TORCH_DP_STORE=os.path.join(out_dir, "store"),
                   PYTHONPATH=repo + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, in_path,
             out_dir], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout_s)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"gang {mode} failed {bad}:\n" + "\n".join(
            log[-3000:] for log in logs))
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(world)]


def shared_result(tmp_path_factory, name: str, compute) -> dict:
    """``compute()`` (a dict of arrays) once for the whole test run:
    under pytest-xdist the workers share one result through a file lock,
    so a module's gang (or oracle) runs once however its tests are
    spread."""
    from filelock import FileLock
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = os.path.join(str(base), f"{name}.npz")
    with FileLock(path + ".lock"):
        if not os.path.exists(path):
            out = compute()
            np.savez(path + ".tmp.npz", **out)
            os.replace(path + ".tmp.npz", path)
    return dict(np.load(path))


if __name__ == "__main__":
    sys.exit(main())
