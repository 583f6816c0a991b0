"""One rank of a CPU Gloo gang for the PyTorch port's data-parallel tests.

    python torch_dp_worker.py <mode> <in.npz> <out_dir>

with TORCH_DP_RANK, TORCH_DP_WORLD and TORCH_DP_STORE (a FileStore path, so
that no TCP port is fixed) in the environment.  It imports torch, numpy and
the port only, pins torch to one intra-op thread, runs every case of
``mode`` and writes ``<out_dir>/rank<r>.npz``:

- ``strategies``: every registry strategy (and the ring at 4 bits, and
  small-bucket variants) on this rank's row of the input gradients, given
  in the JAX package's tree order and layout; ``quantized_ring_ef`` two
  rounds carrying its residual; ``hierarchical`` over a 2 x 2 mesh;
- ``train``: the port's Trainer over the gang from the JAX trainer's
  initial params, one case a config of ``cases.json``: this rank's losses,
  params (JAX layout), BN state, momentum and sync state after the steps;
- ``syncbn``: one sync-BN forward and backward on this rank's shard, the
  gradients meaned over the ranks, and the new BN state;
- ``checks``: ``check_consistency`` after steps and after rank 1 perturbs
  a param, and the augmentation each rank draws for the same batch;
- ``eval``: ``evaluate_sharded`` of seeded TINY params over the gang, and
  its refusal of a batch the ranks do not divide.
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
    ef = st.get("quantized_ring_ef")
    res = ef.init_state(_rows(data, "g", rank), world)
    for r, prefix in enumerate(("g", "h")):
        synced, res = ef(_rows(data, prefix, rank), flat, res)
        save(f"quantized_ring_ef{r}", synced)
        out[f"quantized_ring_ef{r}/res"] = res.numpy()
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
    per = images.shape[0] // world
    mine = slice(rank * per, (rank + 1) * per)
    out = {}
    for name, case in cases.items():
        tr = _trainer(data, case["cfg"], rank)
        k = case.get("steps_per_call", 1)
        losses, grad_max = [], []
        before = tr.momentum()
        for _ in range(case["steps"] // k):
            losses += tr.train_steps(
                np.stack([images[mine]] * k),
                np.stack([labels[mine]] * k)).tolist()
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


def main() -> int:
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
