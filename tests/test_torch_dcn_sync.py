"""The port's two-level LM sync (distributed_pytorch_tpu_torch/lm.py with
``dcn_size``) against the JAX package's, on the CPU.

Every case factors 4 ranks 2 x 2 into ``("dcn", "data")``: each sum then
has two addends, so the port's Gloo sums equal each other bitwise
whatever buffer a value sits in (a sum of two floats does not depend on
their order), and the packages' sums equal each other bitwise.

- **The sync itself** (``LMSync.two_level`` against the JAX
  ``_two_level_sync`` under ``shard_map``, tests/workers/
  torch_dp_worker.py mode ``lm_sync``): per-rank gradients of ZeRO-3
  leaves and of replicated leaves of two spec groups, in one bucket a
  group or in small buckets, plain and with the int8 and int4 dcn ring over
  two rounds carrying the residual: bitwise, the residual included.
- **The trainer** (the gang and oracle of tests/test_torch_fsdp.py: three
  float32 steps from the JAX initial params).  The JAX ``dcn_size > 1``
  step syncs a gradient dp times the flat-dp one (4x here; 2x for the
  ZeRO-3 leaves of the uncompressed sync over 2 slices: its sync points
  sum cotangents that ``shard_map`` has summed already;
  ``test_reference_dcn_gradient_scale`` measures it), which the
  global-norm clip turns into another trajectory; the port syncs the
  flat-dp gradient.  So the plain cases (the dense
  model, ``bucket_mb`` small, ``fsdp``, ``grad_accum=2`` with its one
  exchange after the microbatches, and ``overlap`` with and without fsdp)
  are held against the JAX flat-dp run, in tests/test_torch_lm_dp.py's
  band, and bitwise against each other where the sums are the same
  (small buckets and the streamed sync points change none).  The
  compressed cases (``dcn_compress`` int8 and int4, with fsdp, and with
  overlap, whose residual has the per-group layout) run with the clip off
  on both sides, where Adam does not see a gradient's scale: JAX's
  trajectory is then the port's, and its residual is the port's times 4
  (a power of two scales the ring's levels exactly).  Losses at rtol 1e-4
  (the rings quantize gradients that differ by float32 noise, and a value
  at a rounding boundary lands a level apart), params in
  tests/test_torch_fsdp.py's quantized band (every entry within lr / 2,
  all but 0.1% of a tensor's within the unquantized band; measured: at
  most 7.9e-5 apart at int8, 1.2e-5 at int4, 1.9e-5 with fsdp or
  overlap, and 0.061% of a tensor's entries outside the unquantized band,
  against a trajectory's own ~9.4e-4), and the residual: 99% of the entries within 1e-3 of its largest
  |entry| of JAX's (measured: 99.3-100%), and every one within a level (a
  flipped value sat half a level from both neighbours, so its level is at
  most twice the largest |residual|; measured up to 1.99996x).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_pytorch_tpu import lm as jlm
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu.utils.compat import shard_map
from distributed_pytorch_tpu_torch import lm as tlm
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from test_torch_fsdp import (N, SHAPE, assert_params_in_band,
                             jax_run, port_gang)
from test_torch_lm_dp import cli_run  # noqa: F401  (a fixture)
from workers.torch_dp_worker import run_gang, shared_result

NO_CLIP = 1e9
CASES = {
    "dcn": dict(model=SHAPE, cfg=dict(dcn_size=2)),
    "dcn_bucket_small": dict(model=SHAPE, cfg=dict(dcn_size=2,
                                                   bucket_mb=0.002)),
    "dcn_fsdp": dict(model=SHAPE, cfg=dict(dcn_size=2, fsdp=True)),
    "dcn_grad_accum2": dict(model=SHAPE, cfg=dict(dcn_size=2,
                                                  grad_accum=2)),
    "dcn_overlap": dict(model=SHAPE, cfg=dict(dcn_size=2, overlap=True)),
    "dcn_fsdp_overlap": dict(model=SHAPE, cfg=dict(dcn_size=2, fsdp=True,
                                                   overlap=True)),
    "dcn_int8": dict(model=SHAPE, cfg=dict(dcn_size=2, dcn_compress="int8",
                                           grad_clip=NO_CLIP)),
    "dcn_int4": dict(model=SHAPE, cfg=dict(dcn_size=2, dcn_compress="int4",
                                           grad_clip=NO_CLIP)),
    "dcn_int8_fsdp": dict(model=SHAPE, cfg=dict(
        dcn_size=2, fsdp=True, dcn_compress="int8", grad_clip=NO_CLIP)),
    "dcn_int8_overlap": dict(model=SHAPE, cfg=dict(
        dcn_size=2, overlap=True, dcn_compress="int8", grad_clip=NO_CLIP)),
}
JAX_ONLY = {"dp": dict(model=SHAPE, cfg={}),
            "dp_grad_accum2": dict(model=SHAPE, cfg=dict(grad_accum=2))}
# port case -> the JAX run it is held against (the flat-dp runs for the
# plain cases: the JAX dcn runs carry the gradient-scale fault)
ORACLE = {"dcn": "dp", "dcn_bucket_small": "dp", "dcn_fsdp": "dp",
          "dcn_grad_accum2": "dp_grad_accum2", "dcn_overlap": "dp",
          "dcn_fsdp_overlap": "dp"}
# port case -> the port case it equals bitwise
BITWISE = {"dcn_bucket_small": "dcn", "dcn_overlap": "dcn",
           "dcn_fsdp_overlap": "dcn_fsdp"}
COMPRESSED = ("dcn_int8", "dcn_int4", "dcn_int8_fsdp", "dcn_int8_overlap")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(tmp_path_factory, name: str) -> dict:
    """The module's gang, over every case (``name`` is one of them)."""
    return shared_result(tmp_path_factory, "torch_dcn_port",
                         lambda: port_gang(tmp_path_factory, CASES, "dcn"))


def _jax(tmp_path_factory, oracle: str) -> dict:
    case = {**CASES, **JAX_ONLY}[oracle]
    return shared_result(tmp_path_factory, f"torch_dcn_jax_{oracle}",
                         lambda: jax_run(oracle, case))


# -- the sync itself ---------------------------------------------------------

# port name -> full shape: ZeRO-3 leaves along dims 0 and 1, replicated
# leaves with no tensor axis and with one (the "model" spec group), a few
# ring blocks each
SYNC_SHAPES = {"embed": (40, 60), "final_norm": (301,),
               "layers.0.attn_norm": (5,), "layers.0.wq": (8, 1, 70),
               "layers.0.wo": (1, 6, 100), "layers.0.w_gate": (7, 150),
               "layers.0.w_down": (3, 301)}
SYNC_CASES = {"plain": dict(bucket_bytes=None, compress=None),
              "plain_small": dict(bucket_bytes=2048, compress=None),
              "int8": dict(bucket_bytes=None, compress="int8"),
              "int8_small": dict(bucket_bytes=2048, compress="int8"),
              "int4_small": dict(bucket_bytes=2048, compress="int4")}


def _sync_specs() -> dict:
    return tlm.param_specs(tlm.LMTrainConfig(dp=N, dcn_size=2, fsdp=True),
                           SYNC_SHAPES)


def _sync_inputs() -> dict:
    specs = _sync_specs()
    rng = np.random.default_rng(5)
    out = {f"shape/{k}": np.asarray(v) for k, v in SYNC_SHAPES.items()}
    for prefix in ("g", "h"):
        for name, shape in SYNC_SHAPES.items():
            local = list(shape)
            dim = tlm.fsdp_dim(specs[name])
            if dim is not None:
                local[dim] //= 2
            out[f"{prefix}/{name}"] = rng.standard_normal(
                [N] + local).astype(np.float32)
    return out


def _jax_sync() -> dict:
    inputs = _sync_inputs()
    specs = _sync_specs()
    names = tlm.jax_order(SYNC_SHAPES)
    mesh = jlm.make_lm_mesh(jlm.LMTrainConfig(dp=N, dcn_size=2))
    spec_tree = {k: P(*v) for k, v in specs.items()}
    every = P(tuple(mesh.axis_names))
    out = {}
    for name, case in SYNC_CASES.items():
        bb, compress = case["bucket_bytes"], case["compress"]

        def body(g, res, bb=bb, compress=compress):
            g = {k: v[0] for k, v in g.items()}
            if compress is None:
                return jax.tree.map(lambda x: x[None], jlm._two_level_sync(
                    g, spec_tree, bucket_bytes=bb)), res
            synced, new = jlm._two_level_sync(
                g, spec_tree, bucket_bytes=bb, dcn_compress=compress,
                residual=res[0])
            return jax.tree.map(lambda x: x[None], synced), new[None]

        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(every, every),
                               out_specs=(every, every), check_vma=False))
        sizes = [int(np.prod(inputs[f"g/{n}"].shape[1:])) for n in names]
        res = np.zeros((N, tlm._residual_total_len(
            sizes, [specs[n] for n in names], 2, 2, bb) if compress else 1),
            np.float32)
        for r, prefix in enumerate(("g", "h")):
            synced, res = fn({n: inputs[f"{prefix}/{n}"] for n in names},
                             res)
            for n in names:
                out[f"{name}{r}/{n}"] = np.asarray(synced[n])
            res = np.asarray(res)
            if compress:
                out[f"{name}{r}/res"] = res
    return out


@pytest.fixture(scope="module")
def sync_runs(tmp_path_factory):
    jax_out = shared_result(tmp_path_factory, "torch_dcn_sync_jax",
                            _jax_sync)
    port_out = shared_result(tmp_path_factory, "torch_dcn_sync_port", lambda: {
        f"rank{r}:{k}": v for r, o in enumerate(run_gang(
            "lm_sync", _sync_inputs(),
            str(tmp_path_factory.mktemp("lm_sync_gang")), world=N,
            cases=SYNC_CASES)) for k, v in o.items()})
    return jax_out, port_out


@pytest.mark.parametrize("name", SYNC_CASES)
def test_two_level_sync_bitwise_equals_jax(sync_runs, name):
    jax_out, port_out = sync_runs
    keys = sorted(k for k in jax_out if k.startswith((name + "0/",
                                                      name + "1/")))
    assert len(keys) >= 2 * len(SYNC_SHAPES)
    for k in keys:
        for r in range(N):
            got, want = port_out[f"rank{r}:{k}"], jax_out[k][r]
            assert got.shape == want.shape, (k, r, got.shape, want.shape)
            assert np.array_equal(got, want), \
                (k, r, float(np.abs(got - want).max()))
    if SYNC_CASES[name]["compress"]:
        assert np.abs(jax_out[f"{name}1/res"]).max() > 0


def test_residual_layout_equals_jax():
    """The residual's length, the layout contract of the compressed
    exchange (``_sync_partition`` over the whole tree, or per layer group
    under overlap): JAX's, at the default and small buckets."""
    for kw in (dict(), dict(fsdp=True), dict(overlap=True),
               dict(bucket_mb=0.01), dict(fsdp=True, overlap=True)):
        for bits in ("int8", "int4"):
            cfg = dict(dp=N, dcn_size=2, dcn_compress=bits, **kw)
            jcfg = jlm.LMTrainConfig(model=jtfm.TransformerConfig(**SHAPE),
                                     **cfg)
            want = jlm.lm_sync_state_len(jcfg, jlm.make_lm_mesh(jcfg))
            got = tlm.lm_sync_state_len(tlm.LMTrainConfig(
                model=ttfm.TransformerConfig(**SHAPE), **cfg))
            assert got == want, (kw, bits, got, want)


# -- the trainer -------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_losses_and_params_equal_jax(tmp_path_factory, name):
    jax_out = _jax(tmp_path_factory, ORACLE.get(name, name))
    port = _port(tmp_path_factory, name)
    tol = dict(rtol=1e-4) if name in COMPRESSED else dict(rtol=1e-5)
    for r in range(N):
        np.testing.assert_allclose(port[f"rank{r}:{name}/losses"],
                                   jax_out["losses"], **tol)
    keys = sorted(k[len("p/"):] for k in jax_out if k.startswith("p/"))
    assert keys
    for k in keys:
        got, want = port[f"rank0:{name}/p/{k}"], jax_out[f"p/{k}"]
        assert_params_in_band(got, want, k, quantized=name in COMPRESSED)
        for r in range(1, N):
            assert np.array_equal(port[f"rank{r}:{name}/p/{k}"], got), (k, r)


@pytest.mark.parametrize("name", BITWISE)
def test_bitwise_the_reference_case(tmp_path_factory, name):
    """Small buckets and the streamed sync points change no sum: losses,
    shards, params and moments bitwise the default run's."""
    port = _port(tmp_path_factory, name)
    ref = BITWISE[name]
    keys = [k for k in port if f":{ref}/" in k]
    assert keys
    for k in keys:
        assert np.array_equal(port[k.replace(f":{ref}/", f":{name}/")],
                              port[k]), k


@pytest.mark.parametrize("name", COMPRESSED)
def test_residual_equals_jax_rows(tmp_path_factory, name):
    """Each rank's residual has JAX's layout (the whole tree's partition,
    or under overlap each layer group's in group order) and, times JAX's
    gradient factor, equals JAX's row to float32 noise but for values at
    a rounding boundary, each within a level."""
    jax_out = _jax(tmp_path_factory, name)
    port = _port(tmp_path_factory, name)
    cfg = CASES[name]["cfg"]
    want_all = jax_out["sync_state"]
    assert want_all.shape[1] == tlm.lm_sync_state_len(tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**SHAPE), dp=N, **cfg))
    for r in range(N):
        got = port[f"rank{r}:{name}/sync_state"] * N
        want = want_all[r]
        assert got.shape == want.shape
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got - want).max() <= 2 * scale * (1 + 1e-3), r
        noise = np.abs(got - want) <= 1e-3 * scale
        assert noise.mean() >= 0.99, (r, noise.mean())


def test_reference_dcn_gradient_scale(tmp_path_factory):
    """The JAX dcn step's gradient norm (its ``last_metrics``) is dp times
    the flat-dp run's; the port's dcn run equals its flat-dp run
    (test_losses_and_params_equal_jax).  The reference fault that makes
    the flat-dp run the oracle here (ROADMAP.md queue 3)."""
    flat = _jax(tmp_path_factory, "dp")
    dcn = _jax(tmp_path_factory, "dcn")
    np.testing.assert_allclose(dcn["met"][0] / flat["met"][0], N, rtol=1e-2)


def test_validation_messages_equal_jax():
    """The knobs' value checks: each config the JAX ``validate_lm_cfg``
    refuses, the port refuses with the same ValueError message (the
    overlap check's message is JAX's ``require_lm_overlap_streamable``'s)."""
    bad = [dict(dcn_size=0), dict(dp=3, dcn_size=2),
           dict(dp=4, dcn_size=2, bucket_mb=0),
           dict(dp=4, dcn_size=2, dcn_compress="int2"),
           dict(dp=4, dcn_compress="int8"),
           dict(dp=4, fsdp_gather_dtype="int8"),
           dict(dp=4, fsdp=True, fsdp_gather_dtype="fp8"),
           dict(dp=2, dcn_size=2, fsdp=True), dict(fsdp=True),
           dict(dp=4, overlap=True),
           dict(dp=4, dcn_size=2, grad_accum=2, overlap=True)]
    for kw in bad:
        with pytest.raises(ValueError) as je:
            jlm.validate_lm_cfg(jlm.LMTrainConfig(
                model=jtfm.TransformerConfig(**SHAPE), **kw))
        with pytest.raises(ValueError) as te:
            tlm.validate_lm_cfg(tlm.LMTrainConfig(
                model=ttfm.TransformerConfig(**SHAPE), **kw))
        assert str(te.value) == str(je.value), kw
    for kw in (dict(dp=4, dcn_size=2, fsdp=True, overlap=True),
               dict(dp=4, dcn_size=2, overlap=True),
               dict(dp=4, dcn_size=2, grad_accum=2, fsdp=True, overlap=True),
               dict(dp=4, dcn_size=2, dcn_compress="int4", bucket_mb=1.0)):
        jlm.validate_lm_cfg(jlm.LMTrainConfig(**kw))
        tlm.validate_lm_cfg(tlm.LMTrainConfig(**kw))


# -- lm_cli with the sync flags under launch.py -----------------------------

SYNC_FLAGS = ["--dcn-size", "2", "--fsdp", "--fsdp-gather-dtype", "int8",
              "--dcn-compress", "int8", "--bucket-mb", "1", "--overlap"]


@pytest.fixture(scope="module")
def cli_sync_run(tmp_path_factory):
    """``lm_cli --dp 4`` with every sync flag of the slice through
    launch.py on tests/test_torch_lm_dp.py's corpus and model, and
    ``--generate`` (the whole params gathered on every rank)."""
    import os
    import subprocess
    import sys

    from distributed_pytorch_tpu_torch.data import lm_corpus as tcorpus
    from test_torch_lm_dp import CLI_MODEL, REPO, _free_port

    def compute():
        corpus = tmp_path_factory.mktemp("lm_sync_corpus") / "corpus.txt"
        corpus.write_bytes(tcorpus.synthetic_corpus(40_000, seed=5))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        run = subprocess.run(
            [sys.executable, "-m", "distributed_pytorch_tpu_torch.launch",
             "--nproc-per-node", str(N), "--master-port", str(_free_port()),
             "--", "-m", "distributed_pytorch_tpu_torch.lm_cli",
             "--rendezvous", "env", "--dp", str(N), "--device", "cpu",
             "--corpus", str(corpus), "--generate", "ab", "--max-new", "4"]
            + CLI_MODEL + SYNC_FLAGS,
            env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
        return {"rc": np.asarray(run.returncode),
                "out": np.asarray(run.stdout + run.stderr)}
    return shared_result(tmp_path_factory, "torch_dcn_cli", compute)


def test_lm_cli_sync_flags_under_launch(cli_sync_run, cli_run):
    """Every rank trained with the flags (the trainer's config took them),
    rank 0 alone logged the three steps and generated, and its losses are
    within 1e-3 of one process training the same global batches without
    them (tests/test_torch_lm_dp.py's ``cli_run``: the int8 gathers and
    the int8 dcn ring perturb a loss by ~1e-4)."""
    from test_torch_lm_dp import STEP_LINE
    out = str(cli_sync_run["out"])
    assert int(cli_sync_run["rc"]) == 0, out[-3000:]
    assert all(f"rank {r}/{N}: connected" in out for r in range(N)), out
    steps = STEP_LINE.findall(out)
    assert [int(s) for s, _ in steps] == [1, 2, 3], steps
    np.testing.assert_allclose([float(v) for _, v in steps],
                               cli_run["want"], rtol=1e-3)
    assert "| rank 0/4" in out and "| rank 1/4" not in out
