"""The port's overlapped VGG gradient sync (distributed_pytorch_tpu_torch/
train.py with ``overlap=True``, parallel/strategies.py ``OverlapSync``)
against its own post-backward sync and the JAX package's trainer, on the
CPU.

One 4-rank Gloo gang (tests/workers/torch_dp_worker.py, mode ``train``)
runs tests/test_torch_dp_train.py's setup (the JAX trainer's initial TINY
params, 4 ranks x 4 images, three float32 steps at lr 0.02, no
augmentation) for every overlap-capable strategy, post-backward and
overlapped: ``ddp``, ``bucketed``, ``quantized``, ``quantized_ring``,
``quantized_ring_ef``, ``hierarchical`` (2 x 2) and ``hierarchical`` with
``dcn_compress`` int8 and int4, and small-bucket variants of ``bucketed``,
``quantized_ring``, ``quantized_ring_ef`` and compressed ``hierarchical``
(several buckets, each synced inside the backward at its own layer group).

Held: every overlapped run bitwise its post-backward run: losses, params,
BN state, momentum and residual on every rank (the same bucket plan over
the same leaf order, so the same collectives on the same flat vectors;
where the post-backward sync is one collective over the whole tree, the
overlapped one's buckets sum the same two addends a value on the 2 x 2
mesh, or the plan has one bucket).  The post-backward runs against the
JAX post-backward mesh trainer, in tests/test_torch_dp_train.py's bands:
the float sums (``ddp``, ``bucketed``, ``hierarchical``) at rtol 1e-5 /
atol 1e-6, momentum within 1e-4 of its largest entry plus 1e-5; the
quantized ones within lr times each step's largest quantum (the synced
gradient's largest |value| over 127, or 7 at int4), carried by the
momentum, the first loss at rtol 1e-5 and the later ones at 1e-4 (5e-3 at
int4, whose level is 18x int8's: a value float32 noise moves across a
rounding boundary moves the later losses by up to 1.8e-3, measured).
"""

import jax
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import train as jtrain
from distributed_pytorch_tpu.parallel.mesh import make_mesh
from test_torch_dp_train import (BASE, LR, MOMENTUM_NOISE, N_DEV, STEPS, TOL,
                                 _batch, _flat, _jax_runs)
from workers.torch_dp_worker import run_gang, shared_result

# strategy runs: name -> TrainConfig fields beyond BASE
STRATEGIES = {
    "ddp": dict(strategy="ddp"),
    "bucketed": dict(strategy="bucketed"),
    "quantized": dict(strategy="quantized"),
    "quantized_ring": dict(strategy="quantized_ring"),
    "quantized_ring_ef": dict(strategy="quantized_ring_ef"),
    "hierarchical": dict(strategy="hierarchical", dcn_size=2),
    "hierarchical_int8": dict(strategy="hierarchical", dcn_size=2,
                              dcn_compress="int8"),
    "hierarchical_int4": dict(strategy="hierarchical", dcn_size=2,
                              dcn_compress="int4"),
}
SMALL = dict(overlap_bucket_mb=0.002)
PORT_ONLY = {
    "bucketed_small": dict(strategy="bucketed", **SMALL),
    "quantized_ring_small": dict(strategy="quantized_ring", **SMALL),
    "quantized_ring_ef_small": dict(strategy="quantized_ring_ef", **SMALL),
    "hierarchical_small": dict(strategy="hierarchical", dcn_size=2, **SMALL),
    "hierarchical_int8_small": dict(strategy="hierarchical", dcn_size=2,
                                    dcn_compress="int8", **SMALL),
}
EXACT = ("ddp", "bucketed", "hierarchical")
# quantized strategies: the levels of their quantum
LEVELS = {"quantized": 127, "quantized_ring": 127, "quantized_ring_ef": 127,
          "hierarchical_int8": 127, "hierarchical_int4": 7}
# held against tests/test_torch_dp_train.py's JAX runs of the same names
SHARED_JAX = ("ddp", "quantized_ring_ef", "hierarchical")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run(name: str) -> dict:
    images, labels = _batch()
    kw = STRATEGIES[name]
    cfg = jtrain.TrainConfig(**BASE, **kw)
    if kw["strategy"] == "hierarchical":
        tr = jtrain.Trainer(cfg, num_devices=N_DEV)
    else:
        tr = jtrain.Trainer(cfg, make_mesh(N_DEV))
    out = {f"{name}/losses": np.asarray(
        [float(tr.train_step(images, labels)) for _ in range(STEPS)])}
    out.update(_flat(f"{name}/p", jax.tree.map(np.asarray, tr.params)))
    out.update(_flat(f"{name}/s", jax.tree.map(np.asarray, tr.state)))
    trace = [s for s in jax.tree.leaves(
        tr.opt_state, is_leaf=lambda x: hasattr(x, "trace"))
        if hasattr(s, "trace")][0].trace
    out.update(_flat(f"{name}/m", jax.tree.map(np.asarray, trace)))
    out[f"{name}/sync_state"] = np.asarray(tr.sync_state)
    return out


def _jax(tmp_path_factory, name: str) -> dict:
    if name in SHARED_JAX:
        return shared_result(tmp_path_factory, "torch_dp_train_jax",
                             _jax_runs)
    return shared_result(tmp_path_factory, f"torch_overlap_jax_{name}",
                         lambda: _jax_run(name))


def _jax_init() -> dict:
    """The JAX ``Trainer``'s initial TINY params and BN state (its seed, 1,
    split into the init key, as ``Trainer.__init__`` draws them), keyed as
    tests/test_torch_dp_train.py's runs record them: without compiling a
    trainer, so the gang need not wait for the JAX oracles."""
    from distributed_pytorch_tpu.models import vgg as jvgg
    init_key, _ = jax.random.split(jax.random.key(BASE.get("seed", 1)))
    params, state = jvgg.init(init_key, BASE["model"])
    return {**_flat("init/p", jax.tree.map(np.asarray, params)),
            **_flat("init/s", jax.tree.map(np.asarray, state))}


def test_gang_init_is_the_jax_trainers(tmp_path_factory):
    init = _jax_init()
    want = _jax(tmp_path_factory, "ddp")
    keys = [k for k in want if k.startswith("init/")]
    assert sorted(keys) == sorted(init)
    for k in keys:
        assert np.array_equal(init[k], want[k]), k


def _port(tmp_path_factory, runs: dict, tag: str) -> dict:
    """One gang over ``runs``, each post-backward and overlapped (the
    module's runs make two gangs, which xdist workers run side by side:
    ~5 s off the lane)."""
    def compute():
        images, labels = _batch()
        init = _jax_init()
        inputs = {"images": images, "labels": labels}
        inputs.update({k[len("init/"):]: v for k, v in init.items()
                       if k.startswith("init/")})
        cases = {}
        for name, kw in runs.items():
            for mode in ("post", "overlap"):
                cfg = dict(BASE, **kw, overlap=mode == "overlap")
                cases[f"{name}.{mode}"] = dict(cfg=cfg, steps=STEPS)
        ranks = run_gang("train", inputs,
                         str(tmp_path_factory.mktemp(f"overlap_{tag}")),
                         cases=cases)
        return {f"rank{r}:{k}": v for r, out in enumerate(ranks)
                for k, v in out.items()}
    return shared_result(tmp_path_factory, f"torch_overlap_port_{tag}",
                         compute)


def _port_of(tmp_path_factory, name: str) -> dict:
    if name in STRATEGIES:
        return _port(tmp_path_factory, STRATEGIES, "strategies")
    return _port(tmp_path_factory, PORT_ONLY, "small_buckets")


@pytest.mark.parametrize("name", list(STRATEGIES) + list(PORT_ONLY))
def test_overlap_is_bitwise_post_backward(tmp_path_factory, name):
    port = _port_of(tmp_path_factory, name)
    keys = [k for k in port if f":{name}.post/" in k
            and not k.endswith("/grad_max")]
    assert any(k.endswith("/sync_state") for k in keys)
    for k in keys:
        assert np.array_equal(port[k.replace(".post/", ".overlap/")],
                              port[k]), k
    if "int" in name or "_ef" in name:  # a residual was carried
        assert np.abs(port[f"rank0:{name}.post/sync_state"]).max() > 0


@pytest.mark.parametrize("name", STRATEGIES)
def test_post_backward_equals_jax(tmp_path_factory, name):
    jax_out = _jax(tmp_path_factory, name)
    port = _port_of(tmp_path_factory, name)
    run = f"{name}.post"
    for r in range(N_DEV):
        got, want = port[f"rank{r}:{run}/losses"], jax_out[f"{name}/losses"]
        if name in EXACT:
            np.testing.assert_allclose(got, want, rtol=1e-5)
        else:
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
            np.testing.assert_allclose(
                got, want, rtol=5e-3 if LEVELS[name] == 7 else 1e-4)
    if name in EXACT:
        for tag in ("p", "m"):
            for k in sorted(k for k in jax_out
                            if k.startswith(f"{name}/{tag}/")):
                got = port["rank0:" + k.replace(name, run, 1)]
                if tag == "p":
                    np.testing.assert_allclose(got, jax_out[k], err_msg=k,
                                               **TOL)
                else:
                    err = np.abs(got - jax_out[k]).max()
                    assert err <= MOMENTUM_NOISE * np.abs(
                        jax_out[k]).max() + 1e-5, (k, err)
        return
    quanta = port[f"rank0:{run}/grad_max"] / LEVELS[name]
    bound = LR * sum(quanta[t] * sum(0.9 ** j for j in range(STEPS - t))
                     for t in range(STEPS))
    worst = max(float(np.abs(port["rank0:" + k.replace(name, run, 1)]
                             - jax_out[k]).max())
                for k in jax_out if k.startswith(f"{name}/p/"))
    assert worst <= bound, (worst, bound)
    want_state = jax_out[f"{name}/sync_state"]
    got_state = port[f"rank0:{run}/sync_state"]
    assert got_state.shape == want_state.shape[1:]
