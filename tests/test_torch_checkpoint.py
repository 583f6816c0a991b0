"""The port's checkpoints (distributed_pytorch_tpu_torch/utils/checkpoint.py,
``LMTrainer.save_checkpoint`` / ``maybe_restore``, the VGG ``Checkpointer``)
against the JAX package's, on the CPU in float32.

The container is the JAX package's: ``_crc`` equal over dtypes and shapes,
a port-written npz read by the JAX ``_load_npz_verified`` and a JAX-written
one by the port's, arrays and meta equal.  Each of the four checkpointers
prunes, publishes atomically, flushes its background write, and
quarantines a corrupt generation and falls back to the one before.  The
trainers resume: k steps, a save, a restore into a fresh trainer, n more
steps equal the JAX trainer's uninterrupted run per step (LM losses rtol
1e-5 / atol 1e-6; VGG first loss rtol 1e-5, later ones 1e-4, the lane's
bands) and the port's own uninterrupted run bitwise.  In 4-rank Gloo gangs
(tests/workers/torch_dp_worker.py ``ckpt``): ZeRO-3 and sync-window
trainers saved in both formats and restored bitwise, the ZeRO-3
checkpoints restored onto 2 ranks through ``load_resharded`` with no full
assembly, and a VGG ``all_reduce`` checkpoint restored onto one rank with
rank 0's BN statistics.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import lm as jlm
from distributed_pytorch_tpu import train as jtrain
from distributed_pytorch_tpu.data import cifar10 as jcifar
from distributed_pytorch_tpu.data import pipeline as jpipe
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu.utils import checkpoint as jck
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import lm as tlm
from distributed_pytorch_tpu_torch import train as ttrain
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from distributed_pytorch_tpu_torch.utils import checkpoint as tck
from distributed_pytorch_tpu_torch.utils import faults as tfaults

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "workers"))
import torch_dp_worker as gang  # noqa: E402

LM_TOL = dict(rtol=1e-5, atol=1e-6)
VGG_FIRST, VGG_ALL = dict(rtol=1e-5), dict(rtol=1e-4)
SHAPE = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, head_dim=16,
             d_ff=64)
VGG = dict(model="TINY", strategy="none", batch_size=8, lr=0.02,
           augment=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the bitwise run-to-run checks need the CPU
    step's sums in one order, and parallel workers would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    tfaults.reset()
    yield
    tfaults.reset()


def _lm_batches(n, b=4, s=32, vocab=64, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (b, s)).astype(np.int32)
        out.append((t, np.roll(t, -1, 1).astype(np.int32)))
    return out


def _vgg_batches(n):
    dl = jpipe.DataLoader(jcifar._synthetic(64, seed=0), 8, shuffle=True,
                          seed=0)
    return list(dl)[:n]


# -- the container -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "uint8", "bool", "float16"])
def test_crc_equals_jax(dtype):
    rng = np.random.default_rng(0)
    for shape in [(), (3,), (2, 3, 4), (0, 5)]:
        a = (rng.standard_normal(shape) * 50).astype(dtype)
        assert tck._crc(a) == jck._crc(a), shape


def test_npz_crosses_both_ways(tmp_path):
    """A port-written checkpoint passes the JAX package's verified load and
    a JAX-written one the port's, with equal arrays and meta (the keys are
    each package's own)."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    tck.PyTreeCheckpointer(str(tmp_path / "t")).save(
        {"params": {"w": torch.from_numpy(w), "b": b},
         "opt": {"count": 3}}, 7, meta={"tag": "port"})
    flat, meta = jck._load_npz_verified(str(tmp_path / "t" / "ckpt_7.npz"))
    assert set(flat) == {"params/w", "params/b", "opt/count"}
    np.testing.assert_array_equal(flat["params/w"], w)
    np.testing.assert_array_equal(flat["params/b"], b)
    assert flat["opt/count"].shape == () and int(flat["opt/count"]) == 3
    assert meta["tag"] == "port" and meta["step"] == 7
    assert set(meta["__checksums__"]) == set(flat)
    jck.PyTreeCheckpointer(str(tmp_path / "j")).save(
        {"params": {"w": jax.numpy.asarray(w), "b": jax.numpy.asarray(b)}},
        9, meta={"tag": "jax"})
    jflat, jmeta = tck._load_npz_verified(str(tmp_path / "j" / "ckpt_9.npz"))
    np.testing.assert_array_equal(jflat["params['w']"], w)
    np.testing.assert_array_equal(jflat["params['b']"], b)
    assert jmeta == dict(jmeta, tag="jax", step=9)


def test_fetch_is_owned_and_refuses_bf16():
    """An in-place update after the fetch does not reach the fetched copy
    (the async writer's hazard); a bfloat16 leaf raises."""
    t = torch.ones(4)
    a = tck._fetch(t)
    t.add_(1.0)
    np.testing.assert_array_equal(a, np.ones(4, np.float32))
    with pytest.raises(TypeError, match="bfloat16"):
        tck._fetch(torch.ones(2, dtype=torch.bfloat16), "params/x")


def test_public_names_and_defaults_match_jax():
    import inspect
    for name in dir(jck):
        obj = getattr(jck, name)
        if name.startswith("_") or getattr(obj, "__module__", None) != \
                jck.__name__:
            continue
        assert hasattr(tck, name), name
        if inspect.isclass(obj):
            for meth, fn in vars(obj).items():
                if callable(fn) and (meth == "__init__"
                                     or not meth.startswith("_")):
                    mine = getattr(getattr(tck, name), meth)
                    ps = inspect.signature(fn).parameters
                    tp = inspect.signature(mine).parameters
                    for p, v in ps.items():
                        assert tp[p].default == v.default, (name, meth, p)


# -- the four checkpointers ---------------------------------------------------

def _tree(v):
    return {"p": {"w": torch.full((1024,), float(v)),
                  "frozen": torch.ones(8)}}


def _kinds(tmp_path):
    """kind -> (checkpointer, save(i), the file or directory of generation
    i, restore() -> the restored w's first value or None)."""
    d = str(tmp_path)
    tr = ttrain.Trainer(ttrain.TrainConfig(**VGG), device="cpu")

    def vgg_save(ck, i):
        with torch.no_grad():
            tr.params["fc"]["bias"].fill_(float(i))
        ck.save(tr, i)

    def vgg_restore(ck):
        fresh = ttrain.Trainer(ttrain.TrainConfig(**VGG), device="cpu")
        return (float(fresh.params["fc"]["bias"][0])
                if ck.maybe_restore(fresh) else None)

    def tree_restore(ck):
        got = ck.restore(_tree(0))
        return None if got is None else float(got[0]["p"]["w"][0])

    return {
        "Checkpointer": (
            lambda **kw: tck.Checkpointer(d, **kw), vgg_save,
            lambda i: os.path.join(d, f"ckpt_{i}.npz"), vgg_restore),
        "PyTreeCheckpointer": (
            lambda **kw: tck.PyTreeCheckpointer(d, **kw),
            lambda ck, i: ck.save(_tree(i), i),
            lambda i: os.path.join(d, f"ckpt_{i}.npz"), tree_restore),
        "ShardedCheckpointer": (
            lambda **kw: tck.ShardedCheckpointer(
                d, **{k: v for k, v in kw.items() if k != "async_write"}),
            lambda ck, i: ck.save(_tree(i), i),
            lambda i: os.path.join(d, f"ckpt_{i}"), tree_restore),
        "IncrementalCheckpointer": (
            lambda **kw: tck.IncrementalCheckpointer(d, **kw),
            lambda ck, i: ck.save(_tree(i), i),
            lambda i: os.path.join(d, f"manifest_{i}.json"), tree_restore),
    }


@pytest.mark.parametrize("kind", ["Checkpointer", "PyTreeCheckpointer",
                                  "ShardedCheckpointer",
                                  "IncrementalCheckpointer"])
@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_prune_publish_flush_quarantine(tmp_path, kind, mode):
    """Four saves (background writes where the kind has them) keep the
    newest three, leave no temporary file, and restore the newest; the
    newest corrupted (its file, shard file or delta file) is quarantined
    to ``*.corrupt`` and the restore falls back to the one before."""
    make, save, path, restore = _kinds(tmp_path)[kind]
    ck = make(keep=3, async_write=True)
    for i in range(1, 5):
        save(ck, i)
    assert [s for s, _ in ck.list()] == [2, 3, 4]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert restore(make()) == 4.0
    target = path(4)
    if kind == "ShardedCheckpointer":
        target = os.path.join(target, "proc0.npz")
    elif kind == "IncrementalCheckpointer":
        target = os.path.join(str(tmp_path), "inc_4.npz")
    tfaults.corrupt_file(target, mode=mode, seed=5)
    assert restore(make()) == 3.0
    assert os.path.exists(path(4) + ".corrupt")
    assert not os.path.exists(path(4))


def test_ckpt_corrupt_plan_fires_on_publish(tmp_path):
    """The ``ckpt_corrupt`` plan corrupts the next checkpoint published,
    whole-tree or sharded; the restore quarantines it and takes the one
    before."""
    for sharded in (False, True):
        d = str(tmp_path / str(sharded))
        ck = (tck.ShardedCheckpointer(d) if sharded
              else tck.PyTreeCheckpointer(d))
        ck.save(_tree(1), 1)
        tfaults.install(tfaults.FaultPlan(kind="ckpt_corrupt", seed=11))
        ck.save(_tree(2), 2)
        tfaults.reset()
        got, meta = ck.restore(_tree(0))
        assert meta["step"] == 1 and float(got["p"]["w"][0]) == 1.0
        assert os.path.exists(os.path.join(
            d, "ckpt_2.corrupt" if sharded else "ckpt_2.npz.corrupt"))


def test_sharded_layout_and_corrupt_metadata(tmp_path):
    """The shard index is the JAX package's schema (a piece's global slice,
    shape and crc; a whole value's slices None); a replicated copy is
    written once; a garbled meta.json quarantines its generation."""
    ck = tck.ShardedCheckpointer(str(tmp_path))
    full = torch.arange(12.0).reshape(4, 3)
    piece = tck.Shard(full[2:4], (4, 3), (slice(2, 4), slice(0, 3)))
    ck.save({"t": {"a": piece, "r": torch.ones(2),
                   "copy": tck.Shard(torch.ones(3), (3,), (slice(0, 3),),
                                     replica=1), "n": 5}}, 1)
    with open(tmp_path / "ckpt_1" / "proc0.idx.json") as f:
        idx = json.load(f)
    assert set(idx) == {"t/a", "t/r", "t/n"}
    (a,) = idx["t/a"]
    assert a["slices"] == [[2, 4], [0, 3]] and a["shape"] == [4, 3]
    assert a["crc"] == jck._crc(full[2:4].numpy())
    assert idx["t/n"][0]["slices"] is None
    with open(tmp_path / "ckpt_1" / "meta.json") as f:
        assert json.load(f) == {"step": 1, "nprocs": 1}
    ck.save({"t": {"r": torch.ones(2)}}, 2)
    (tmp_path / "ckpt_2" / "meta.json").write_text("{not json", "utf-8")
    got, meta = ck.restore({"t": {"r": torch.zeros(2)}})
    assert meta["step"] == 1 and (tmp_path / "ckpt_2.corrupt").exists()


def test_incremental_writes_only_changed_leaves(tmp_path):
    ck = tck.IncrementalCheckpointer(str(tmp_path))
    ck.save(_tree(1), 1)
    ck.save(_tree(2), 2)
    with open(tmp_path / "manifest_2.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["p/w"]["file"] == "inc_2.npz"
    assert leaves["p/frozen"]["file"] == "inc_1.npz"
    with np.load(tmp_path / "inc_2.npz") as z:
        assert z.files == ["p/w"]


# -- the trainers ---------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_jax():
    """The JAX LM trainer's initial params and 4 uninterrupted losses."""
    cfg = jlm.LMTrainConfig(model=jtfm.TransformerConfig(**SHAPE),
                            compute_dtype=None)
    jtr = jlm.LMTrainer(cfg)
    p0 = jax.tree.map(np.array, jtr.params)
    batches = _lm_batches(4)
    return p0, batches, [float(jtr.train_step(*b)) for b in batches]


def _lm_port(p0):
    tr = tlm.LMTrainer(tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**SHAPE), compute_dtype=None),
        device="cpu")
    tr.load_state(convert.from_jax_params(p0, device="cpu"))
    return tr


@pytest.mark.parametrize("sharded", [False, True])
def test_lm_resume_matches_jax_and_itself(lm_jax, tmp_path, sharded):
    """2 steps, a save, a restore into a fresh trainer, 2 more steps: the
    losses equal the JAX trainer's uninterrupted run per step and the
    port's own bitwise; the Adam count comes back an int."""
    p0, batches, want = lm_jax
    whole = _lm_port(p0)
    own = [float(whole.train_step(*b)) for b in batches]
    first = _lm_port(p0)
    got = [float(first.train_step(*b)) for b in batches[:2]]
    first.save_checkpoint(str(tmp_path), sharded=sharded)
    first.flush_checkpoints()
    # a fresh trainer made as the first was: its leaves in the same order,
    # which the step's global-norm sum follows
    fresh = _lm_port(jax.tree.map(np.zeros_like, p0))
    assert fresh.maybe_restore(str(tmp_path)) == 2
    assert type(fresh.opt_state["count"]) is int
    got += [float(fresh.train_step(*b)) for b in batches[2:]]
    np.testing.assert_allclose(got, want, **LM_TOL)
    assert got == own
    for n, p in whole.params.items():
        assert torch.equal(fresh.params[n], p), n


def test_lm_maybe_restore_takes_the_newest_format(tmp_path):
    """A directory of both formats resumes from the newest step."""
    tr = tlm.LMTrainer(tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**SHAPE), compute_dtype=None),
        device="cpu")
    b = _lm_batches(2)
    tr.train_step(*b[0])
    tr.save_checkpoint(str(tmp_path))
    tr.train_step(*b[1])
    tr.save_checkpoint(str(tmp_path), sharded=True)
    tr.flush_checkpoints()
    fresh = tlm.LMTrainer(tr.cfg, device="cpu")
    assert fresh.maybe_restore(str(tmp_path)) == 2
    assert all(torch.equal(fresh.params[n], p) for n, p in tr.params.items())


def test_vgg_resume_matches_jax_and_itself(tmp_path):
    """The VGG Checkpointer: 2 steps, a save, a restore into a fresh
    trainer (params, BN state, momentum, the step), 2 more steps: the
    losses within the lane's band of the JAX trainer's uninterrupted run,
    and bitwise the port's own."""
    batches = _vgg_batches(4)
    jtr = jtrain.Trainer(jtrain.TrainConfig(**VGG))
    params, state = (jax.tree.map(np.array, t) for t in (jtr.params,
                                                          jtr.state))
    want = [float(jtr.train_step(*b)) for b in batches]

    def port():
        tr = ttrain.Trainer(ttrain.TrainConfig(**VGG), device="cpu")
        tr.load_state(*convert.from_jax_vgg(params, state, device="cpu"))
        return tr

    whole = port()
    own = [float(whole.train_step(*b)) for b in batches]
    first = port()
    got = [float(first.train_step(*b)) for b in batches[:2]]
    ck = tck.Checkpointer(str(tmp_path))
    ck.save(first, 1)
    fresh = ttrain.Trainer(ttrain.TrainConfig(**VGG), device="cpu")
    assert ck.maybe_restore(fresh) == 1 and fresh._step == 2
    got += [float(fresh.train_step(*b)) for b in batches[2:]]
    np.testing.assert_allclose(got[0], want[0], **VGG_FIRST)
    np.testing.assert_allclose(got, want, **VGG_ALL)
    assert got == own
    for k, v in whole.momentum().items():
        for n, t in v.items():
            assert torch.equal(fresh.momentum()[k][n], t), (k, n)


def test_vgg_restore_puts_missing_momentum_back_to_none(tmp_path):
    """A checkpoint saved before the first step holds no momentum buffer:
    restored into a trainer that has stepped, the buffers are gone, and
    the next step is bitwise a fresh trainer's first."""
    b = _vgg_batches(2)
    tr = ttrain.Trainer(ttrain.TrainConfig(**VGG), device="cpu")
    ck = tck.Checkpointer(str(tmp_path))
    ck.save(tr, 0)
    tr.train_step(*b[0])
    assert ck.maybe_restore(tr) == 0 and tr._step == 0
    assert all(buf is None for v in tr.opt_state["momentum"].values()
               for buf in v.values())
    fresh = ttrain.Trainer(ttrain.TrainConfig(**VGG), device="cpu")
    assert float(tr.train_step(*b[1])) == float(fresh.train_step(*b[1]))
    for k, v in fresh.params.items():
        for n, t in v.items():
            assert torch.equal(tr.params[k][n], t), (k, n)


# -- gangs of 4 (and 2) ranks ---------------------------------------------------

GANG_MODEL = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                  head_dim=16, d_ff=64)


@pytest.fixture(scope="module")
def ckpt_gang(tmp_path_factory):
    def compute():
        base = str(tmp_path_factory.mktemp("ckpt_gang"))
        rng = np.random.default_rng(11)
        tokens = rng.integers(0, 64, (4, 8, 32)).astype(np.int32)
        images = rng.integers(0, 256, (8, 32, 32, 3)).astype(np.uint8)
        inputs = {"tokens": tokens,
                  "targets": np.roll(tokens, -1, 2).astype(np.int32),
                  "images": images,
                  "labels": rng.integers(0, 10, 8).astype(np.int32)}
        cases = {"model": GANG_MODEL, "dir": os.path.join(base, "ck")}
        out = {}
        for world in (4, 2):
            for r, res in enumerate(gang.run_gang(
                    "ckpt", inputs, os.path.join(base, f"w{world}"),
                    world=world, cases=cases)):
                out.update({f"w{world}/r{r}/{k}": v for k, v in res.items()})
        # the VGG checkpoint restored onto one rank, here
        tr = ttrain.Trainer(ttrain.TrainConfig(
            model="TINY", strategy="none", batch_size=2, augment=False),
            device="cpu")
        out["vgg1/epoch"] = np.asarray(tck.Checkpointer(os.path.join(
            cases["dir"], "vgg")).maybe_restore(tr))
        for tag, tree in (("p", tr.params), ("s", tr.state)):
            for k1, v in tree.items():
                for n, t in v.items():
                    out[f"vgg1/{tag}/{k1}/{n}"] = t.detach().numpy()
        return out
    return gang.shared_result(tmp_path_factory, "torch_ckpt_gang", compute)


@pytest.mark.parametrize("name", ["fsdp", "window"])
@pytest.mark.parametrize("fmt", ["sharded", "whole"])
def test_gang_save_restore_bitwise(ckpt_gang, name, fmt):
    """4 ranks (ZeRO-3, or sync windows over 2 slices): every rank's
    restored pieces bitwise what it saved, and 2 more steps from the
    restore bitwise the uninterrupted run's."""
    for r in range(4):
        g = {k[len(f"w4/r{r}/"):]: v for k, v in ckpt_gang.items()
             if k.startswith(f"w4/r{r}/")}
        assert int(g[f"{name}/{fmt}/step"]) == 2
        assert bool(g[f"{name}/{fmt}/equal"])
        np.testing.assert_array_equal(g[f"{name}/{fmt}/losses"],
                                      g[f"{name}/cont"])


@pytest.mark.parametrize("fmt", ["sharded", "whole"])
def test_gang_reshard_4_to_2(ckpt_gang, fmt):
    """The 4-rank ZeRO-3 checkpoints restored onto 2 ranks: the whole
    params and Adam moments bitwise the 4-rank run's at the save, and the
    sharded one through intersections alone (no full assembly)."""
    keys = [k[len("w4/r0/fsdp/"):] for k in ckpt_gang
            if k.startswith("w4/r0/fsdp/") and k.split("/")[3] in
            ("p", "mu", "nu")]
    assert len(keys) == 3 * len(tlm.param_shapes(
        ttfm.TransformerConfig(**GANG_MODEL)))
    for r in range(2):
        assert int(ckpt_gang[f"w2/r{r}/re/{fmt}/step"]) == 2
        for k in keys:
            np.testing.assert_array_equal(
                ckpt_gang[f"w2/r{r}/re/{fmt}/{k}"],
                ckpt_gang[f"w4/r0/fsdp/{k}"], err_msg=k)
        if fmt == "sharded":
            assert int(ckpt_gang[f"w2/r{r}/re/stats/full_assemblies"]) == 0
            assert int(ckpt_gang[f"w2/r{r}/re/stats/intersections"]) > 0


def test_vgg_cross_topology_restore(ckpt_gang):
    """A 4-rank all_reduce checkpoint restored onto one rank: the params,
    and rank 0's BN running statistics."""
    assert int(ckpt_gang["vgg1/epoch"]) == 1
    keys = [k[len("vgg1/"):] for k in ckpt_gang if k.startswith("vgg1/")
            and k != "vgg1/epoch"]
    assert any(k.startswith("s/") for k in keys)
    differ = False
    for k in keys:
        np.testing.assert_array_equal(ckpt_gang[f"vgg1/{k}"],
                                      ckpt_gang[f"w4/r0/vgg/{k}"], err_msg=k)
        if k.startswith("s/"):
            differ |= not np.array_equal(ckpt_gang[f"w4/r1/vgg/{k}"],
                                         ckpt_gang[f"w4/r0/vgg/{k}"])
    assert differ  # the ranks' statistics differ: rank 0's were taken


def test_checkpoint_io_spans_match_jax(tmp_path):
    """Checkpoint IO on the telemetry timeline: a save and a restore in
    each format give the JAX package's records (``ckpt_save`` /
    ``ckpt_restore`` / ``ckpt_reshard`` spans in the ``ckpt`` lane with
    their argument keys, each beside a ``host_rss_bytes`` gauge in the
    ``mem`` lane)."""
    from distributed_pytorch_tpu.utils import telemetry as jtel
    from distributed_pytorch_tpu_torch.utils import telemetry as ttel
    w = np.arange(256, dtype=np.float32)
    seen = []
    for tel, ck, tree in (
            (ttel, tck, {"p": {"w": torch.from_numpy(w.copy())}}),
            (jtel, jck, {"p": {"w": jax.numpy.asarray(w)}})):
        d = tmp_path / tel.__name__.split(".")[0]
        tel.enable(str(d / "run"), rank=0)
        try:
            for cls in (ck.PyTreeCheckpointer, ck.ShardedCheckpointer):
                c = cls(str(d / cls.__name__))
                c.save(tree, 3)
                c.wait()
                c.restore(tree)
            c.load_resharded(tree)
        finally:
            tel.disable()
        (_, recs), = tel.read_run(str(d / "run"))
        seen.append([(r["type"], r["name"], r["phase"],
                      sorted(r.get("args", {}))) for r in recs])
    assert seen[0] == seen[1]
    assert [x[1] for x in seen[0] if x[0] == "span"] == [
        "ckpt_save", "ckpt_restore", "ckpt_save", "ckpt_restore",
        "ckpt_reshard"]
