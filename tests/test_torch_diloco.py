"""The port's DiLoCo outer optimizer and per-slice windows against the JAX
package's, on the CPU.

- ``OuterOptimizer``: the tree and flat forms bitwise the JAX class under
  ``jax.jit`` (XLA fuses its ``mu * m + d`` and ``a + lr * s`` into fused
  multiply-adds, which the port rounds alike), ``trivial`` and ``KINDS``.
- A trivial outer optimizer (momentum 0, lr 1) is bitwise the plain window
  in both trainers; so are per-slice windows whose entries all equal the
  base (tests/test_torch_localsgd.py's runs, from the same gang).
- ``nesterov`` and ``momentum`` over two boundaries, and nesterov with
  ``staleness=1``: the LM anchor and outer momentum (4-rank gang, 2 x 2,
  tests/test_torch_localsgd.py's oracle: JAX's gradient divided by its
  reference factor) and the VGG anchor with the flat momentum tail of
  ``sync_state`` (tests/test_torch_localsgd.py's VGG setting), in the
  bands of that module.
- Per-slice windows ``(2, 4)``: after three steps the skipping slice keeps
  its three steps of delta, the other its one, as JAX's rows; the masked
  exchange gives a skipper an exact zero contribution: its anchor and
  int4 residual bitwise the all-in exchange's on a zeroed delta, its live
  delta untouched, the others reset (JAX tests/test_diloco.py's ledger).
- ``require_sync_window``: every message of the JAX check, directly and
  through both trainers' configs and both CLIs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import cli as jcli
from distributed_pytorch_tpu import lm as jlm
from distributed_pytorch_tpu import lm_cli as jlm_cli
from distributed_pytorch_tpu import train as jtrain
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu.parallel import strategies as jstrat
from distributed_pytorch_tpu.parallel.mesh import make_mesh
from distributed_pytorch_tpu_torch import cli as tcli
from distributed_pytorch_tpu_torch import lm as tlm
from distributed_pytorch_tpu_torch import lm_cli as tlm_cli
from distributed_pytorch_tpu_torch import train as ttrain
from distributed_pytorch_tpu_torch.parallel import strategies as tstrat
from test_torch_fsdp import N, SHAPE, _batch, _init, assert_params_in_band
from test_torch_localsgd import (LCASES, MOMENTUM_NOISE, TOL, VCASES,
                                 _vkeys, jax_lm_run, lm_gang, vgg_gang,
                                 vgg_init, vgg_jax, window_state)
from test_torch_lm_dp import cli_run  # noqa: F401  (a fixture)
from workers.torch_dp_worker import run_gang, shared_result

W2 = LCASES["w2"]["cfg"]
DCASES = {
    "w2": LCASES["w2"],
    "w2_trivial": dict(model=SHAPE, cfg=dict(
        W2, outer_opt="nesterov", outer_momentum=0.0, outer_lr=1.0)),
    "w2_per_uniform": dict(model=SHAPE, cfg=dict(
        W2, sync_every_per_slice=[2, 2])),
    "w2_nesterov": dict(model=SHAPE, cfg=dict(W2, outer_opt="nesterov",
                                              outer_momentum=0.5)),
    "w2_momentum": dict(model=SHAPE, cfg=dict(
        W2, outer_opt="momentum", outer_momentum=0.5, outer_lr=0.7)),
    "w2_nesterov_staleness1": dict(model=SHAPE, cfg=dict(
        W2, outer_opt="nesterov", outer_momentum=0.5, staleness=1)),
    "w2_per": dict(model=SHAPE, steps=3, cfg=dict(
        W2, sync_every_per_slice=[2, 4])),
}
DJAX = ("w2_nesterov", "w2_momentum", "w2_nesterov_staleness1", "w2_per")
BITWISE = {"w2_trivial": "w2", "w2_per_uniform": "w2"}
VWIN = VCASES["ddp"]
VD = {
    "ddp": VWIN,
    "ddp_trivial": dict(VWIN, outer_opt="nesterov", outer_momentum=0.0),
    "ddp_nesterov": dict(VWIN, outer_opt="nesterov", outer_momentum=0.5),
    "hierarchical_momentum": dict(VCASES["hierarchical"],
                                  outer_opt="momentum", outer_momentum=0.5,
                                  outer_lr=0.7),
}
VDJAX = ("ddp_nesterov", "hierarchical_momentum")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the optimizer itself ------------------------------------------------------

def _leaves(seed: int, scale: float) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in ((64, 33), (7,), (3, 3, 5, 9))]


@pytest.mark.parametrize("kind", jstrat.OuterOptimizer.KINDS)
@pytest.mark.parametrize("mu,lr", [(0.9, 1.0), (0.5, 0.7), (0.0, 1.0),
                                   (0.0, 0.5)])
def test_outer_optimizer_bitwise_equals_jax(kind, mu, lr):
    a, d, m = _leaves(0, 1.0), _leaves(1, 1e-3), _leaves(2, 1e-2)
    jo = jstrat.OuterOptimizer(kind, mu, lr)
    to = tstrat.OuterOptimizer(kind, mu, lr)
    assert to.trivial == jo.trivial == (mu == 0.0 and lr == 1.0)
    ja, jm = jax.jit(jo.apply)(a, d, m)
    ta, tm = to.apply(*([torch.from_numpy(x) for x in t] for t in (a, d, m)))
    for x, y in zip(list(ja) + list(jm), ta + tm):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    flat = np.concatenate([x.ravel() for x in m])
    ja, jf = jax.jit(jo.apply_flat)(a, d, jnp.asarray(flat))
    ta, tf = to.apply_flat([torch.from_numpy(x) for x in a],
                           [torch.from_numpy(x) for x in d],
                           torch.from_numpy(flat))
    for x, y in zip(ja, ta):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    assert to.state_len(ta) == jo.state_len(ja) == flat.size
    if to.trivial:  # no state: the plain add, the momentum handed back
        assert tf.data_ptr() == torch.from_numpy(flat).data_ptr() or \
            np.array_equal(tf.numpy(), flat)
    z = to.init_state([torch.from_numpy(x) for x in a])
    assert all(t.dtype == torch.float32 and not t.any() for t in z)
    assert not to.init_flat([torch.from_numpy(x) for x in a]).any()


def test_outer_optimizer_kinds_and_message():
    assert tstrat.OuterOptimizer.KINDS == jstrat.OuterOptimizer.KINDS
    for pkg in (jstrat, tstrat):
        with pytest.raises(ValueError) as e:
            pkg.OuterOptimizer("adamw")
        if pkg is jstrat:
            want = str(e.value)
    assert str(e.value) == want


# -- the LM gang -----------------------------------------------------------------

def _lm_port(tmp_path_factory) -> dict:
    """The module's LM gang over every case (the tests fetch their JAX
    runs first, so that one worker's gang overlaps the others' JAX)."""
    return shared_result(tmp_path_factory, "torch_diloco_lm_port",
                         lambda: lm_gang(tmp_path_factory, DCASES,
                                         "diloco_lm"))


def _lm_jax(tmp_path_factory, name: str) -> dict:
    case = DCASES[name]
    return shared_result(
        tmp_path_factory, f"torch_diloco_lm_jax_{name}",
        lambda: jax_lm_run(dict(case, cfg=dict(
            case["cfg"], sync_every_per_slice=tuple(
                case["cfg"].get("sync_every_per_slice") or ()) or None)),
            steps=case.get("steps", 4)))


@pytest.mark.parametrize("name", BITWISE)
def test_lm_trivial_and_uniform_windows_are_bitwise_the_plain_window(
        tmp_path_factory, name):
    ref = BITWISE[name]
    lm_port = _lm_port(tmp_path_factory)
    keys = [k for k in lm_port if f":{ref}/" in k]
    assert keys
    for k in keys:
        assert np.array_equal(lm_port[k.replace(f":{ref}/", f":{name}/")],
                              lm_port[k]), k
    assert not any("outer_m" in k for k in lm_port if f":{name}/" in k)


@pytest.mark.parametrize("name", DJAX)
def test_lm_outer_and_per_slice_equal_jax(tmp_path_factory, name):
    """Losses rtol 1e-5, the anchor in the params' band, the outer
    momentum (the anchor's layout, each rank holding the whole of its
    replicated leaves) and the slices' deltas against JAX's rows."""
    jax_out = _lm_jax(tmp_path_factory, name)
    lm_port = _lm_port(tmp_path_factory)
    for r in range(N):
        np.testing.assert_allclose(lm_port[f"rank{r}:{name}/losses"],
                                   jax_out["losses"], rtol=1e-5)
    keys = sorted(k[len("p/"):] for k in jax_out if k.startswith("p/"))
    for k in keys:
        assert_params_in_band(lm_port[f"rank0:{name}/p/{k}"],
                              jax_out[f"p/{k}"], k)
    cfg = DCASES[name]["cfg"]
    outer = sorted(k for k in jax_out if k.startswith("outer_m/"))
    assert bool(outer) == ("outer_opt" in cfg)
    for k in outer:
        for r in range(N):
            got = lm_port[f"rank{r}:{name}/outer_m/{k[len('outer_m/'):]}"]
            assert_params_in_band(got, jax_out[k], k)
        assert np.abs(jax_out[k]).max() > 0
    delta = window_state(lm_port, name, "delta", cfg)
    for k, v in delta.items():
        want = jax_out[f"delta/{k}"]
        if name == "w2_per":
            # step 3: slice 0 exchanged at step 2 (one step since), slice
            # 1 skipped it (three steps of its own delta)
            assert np.abs(v[0]).max() > 0 and np.abs(v[1]).max() > 0
            assert np.abs(v[1]).max() > np.abs(v[0]).max(), k
        if want.any():
            assert_params_in_band(v, want, k)
        else:
            assert not v.any(), k


@pytest.fixture(scope="module")
def ledger(tmp_path_factory):
    def compute():
        tokens, targets = _batch()
        inputs = {"tokens": tokens, "targets": targets}
        inputs.update({f"p/{k}": v for k, v in _init(SHAPE).items()})
        case = dict(model=SHAPE, steps=5, cfg=dict(
            W2, sync_every_per_slice=[2, 4], dcn_compress="int4"))
        ranks = run_gang("ledger", inputs,
                         str(tmp_path_factory.mktemp("diloco_ledger")),
                         world=N, cases={"per_int4": case})
        return {f"rank{r}:{k}": v for r, o in enumerate(ranks)
                for k, v in o.items()}
    return shared_result(tmp_path_factory, "torch_diloco_ledger", compute)


def test_masked_exchange_is_an_exact_zero_delta_with_the_ef_ledger(ledger):
    """Past two boundaries (the int4 residual armed): the exchange with
    slice 1 masked out is bitwise the all-in exchange with slice 1's delta
    zeroed, anchor and residual; slice 1's live delta crosses it
    untouched and slice 0's is reset (JAX tests/test_diloco.py:258)."""
    pre = "per_int4/"
    names = sorted(k.split("/anchor/", 1)[1] for k in ledger
                   if k.startswith(f"rank0:{pre}masked/anchor/"))
    assert names
    for r in range(N):
        s = r // 2  # the rank's slice
        assert np.abs(ledger[f"rank{r}:{pre}res_before"]).max() > 0
        np.testing.assert_array_equal(ledger[f"rank{r}:{pre}masked/res"],
                                      ledger[f"rank{r}:{pre}manual/res"])
        for n in names:
            np.testing.assert_array_equal(
                ledger[f"rank{r}:{pre}masked/anchor/{n}"],
                ledger[f"rank{r}:{pre}manual/anchor/{n}"])
            out = ledger[f"rank{r}:{pre}masked/delta/{n}"]
            live = ledger[f"rank{r}:{pre}live/{n}"]
            if s == 1:
                np.testing.assert_array_equal(out, live)
            else:
                assert not out.any()
        assert any(ledger[f"rank{r}:{pre}live/{n}"].any() for n in names)


# -- the VGG gang ----------------------------------------------------------------

def _vgg_runs(tmp_path_factory, *names) -> tuple[dict, dict]:
    """(JAX's runs of ``names``, the port's gang over every case), the
    JAX runs first (tests/test_torch_localsgd.py's ``vgg_jax``)."""
    jax_out = {}
    for name in names:
        jax_out.update(vgg_jax(tmp_path_factory, "torch_diloco_vgg_jax", VD,
                               name))
    init = shared_result(tmp_path_factory, "torch_window_vgg_init",
                         vgg_init)
    port = shared_result(tmp_path_factory, "torch_diloco_vgg_port",
                         lambda: vgg_gang(tmp_path_factory, init, VD,
                                          "diloco_vgg"))
    return jax_out, port


def test_vgg_trivial_outer_is_bitwise_the_plain_window(tmp_path_factory):
    _, port = _vgg_runs(tmp_path_factory)
    keys = [k for k in port if ":ddp/" in k]
    assert keys
    for k in keys:
        assert np.array_equal(port[k.replace(":ddp/", ":ddp_trivial/")],
                              port[k]), k
    assert port["rank0:ddp_trivial/sync_state"].size == 0


@pytest.mark.parametrize("name", VDJAX)
def test_vgg_outer_equals_jax(tmp_path_factory, name):
    """Losses, the anchor and each rank's momentum as in tests/
    test_torch_localsgd.py; the outer momentum, the flat tail of
    ``sync_state`` (raveled in the JAX layout), against JAX's row within
    the momentum's band."""
    jax_out, port = _vgg_runs(tmp_path_factory, name)
    for r in range(N):
        np.testing.assert_allclose(port[f"rank{r}:{name}/losses"],
                                   jax_out[f"{name}/losses"], rtol=1e-5)
    for k in _vkeys(jax_out, name, "p"):
        np.testing.assert_allclose(port[f"rank0:{k}"], jax_out[k],
                                   err_msg=k, **TOL)
    for k in _vkeys(jax_out, name, "m"):
        for r in range(N):
            want = jax_out[k][r]
            err = np.abs(port[f"rank{r}:{k}"] - want).max()
            assert err <= MOMENTUM_NOISE * np.abs(want).max() + 1e-5, (k, r)
    for r in range(N):
        got = port[f"rank{r}:{name}/sync_state"]
        want = jax_out[f"{name}/sync_state"][r]
        assert got.shape == want.shape and np.abs(want).max() > 0
        err = np.abs(got - want).max()
        assert err <= MOMENTUM_NOISE * np.abs(want).max() + 1e-6, (r, err)


# -- require_sync_window, through every door --------------------------------------

OK = dict(sync_every=4, max_sync_every=4, mesh=True)
DIRECT = [
    dict(sync_every=0), dict(sync_every=1, max_sync_every=0),
    dict(sync_every=4, staleness=-1), dict(OK, staleness=4),
    dict(sync_every=1, max_sync_every=4, staleness=1), dict(OK, mesh=False),
    dict(OK, pp=True), dict(OK, grad_accum=2),
    dict(OK, overlap=True, trainer="train"),
    dict(OK, dcn_size=1, trainer="lm"),
    dict(OK, steps_per_loop=3, trainer="train"),
    dict(OK, outer_opt="adamw"),
    dict(sync_every=1, max_sync_every=1, mesh=True, outer_opt="nesterov"),
    dict(OK, outer_opt="nesterov", outer_momentum=1.0),
    dict(OK, outer_opt="nesterov", outer_lr=0.0),
    dict(OK, trainer="train", sync_every_per_slice=(4, 8)),
    dict(OK, trainer="lm", staleness=1, dcn_size=2,
         sync_every_per_slice=(4, 8)),
    dict(OK, trainer="lm", dcn_size=2, sync_every_per_slice=(4, 8, 4)),
    dict(OK, trainer="lm", dcn_size=2, sync_every_per_slice=(4, 6)),
    dict(OK, trainer="lm", dcn_size=2, sync_every_per_slice=(8, 8)),
    dict(OK, trainer="lm", dcn_size=2, sync_every_per_slice=(4, 0)),
    dict(sync_every=1, trainer="lm", sync_every_per_slice=(1, 1)),
    # coherent
    dict(OK), dict(sync_every=1, mesh=False),
    dict(OK, overlap=True, dcn_size=2, trainer="lm"),
    dict(OK, outer_opt="nesterov"),
    dict(OK, trainer="lm", dcn_size=2, sync_every_per_slice=(4, 8)),
]


def _outcome(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("kw", DIRECT, ids=range(len(DIRECT)))
def test_require_sync_window_messages_equal_jax(kw):
    want = _outcome(jstrat.require_sync_window, **kw)
    assert _outcome(tstrat.require_sync_window, **kw) == want
    assert (want is None) == (kw in DIRECT[-5:])


LM_CFGS = [dict(sync_every=2), dict(dp=4, dcn_size=2, sync_every=2),
           dict(dp=4, dcn_size=2, sync_every=2, staleness=2),
           dict(dp=4, dcn_size=2, sync_every=2, grad_accum=2),
           dict(dp=4, dcn_size=2, outer_opt="nesterov"),
           dict(dp=4, dcn_size=2, sync_every=2, outer_opt="momentum",
                outer_momentum=-0.1),
           dict(dp=4, dcn_size=2, sync_every=2, sync_every_per_slice=(2, 3)),
           dict(dp=4, dcn_size=2, sync_every=2, overlap=True, fsdp=True,
                dcn_compress="int4", outer_opt="nesterov",
                sync_every_per_slice=(2, 6)),
           dict(dp=4, dcn_size=2, max_sync_every=8)]


@pytest.mark.parametrize("kw", LM_CFGS, ids=range(len(LM_CFGS)))
def test_lm_config_window_checks_equal_jax(kw):
    model = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=1,
                 head_dim=64, d_ff=128)
    want = _outcome(jlm.validate_lm_cfg, jlm.LMTrainConfig(
        model=jtfm.TransformerConfig(**model), **kw))
    from distributed_pytorch_tpu_torch.models import transformer as ttfm
    got = _outcome(tlm.validate_lm_cfg, tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**model), **kw))
    assert got == want


VGG_CFGS = [dict(strategy="none", sync_every=2),
            dict(strategy="ddp", sync_every=2, overlap=True),
            dict(strategy="ddp", outer_opt="momentum"),
            dict(strategy="ddp", sync_every=2, outer_opt="nesterov",
                 outer_lr=-1.0),
            dict(strategy="ddp", sync_every=4, steps_per_loop=6),
            dict(strategy="ddp", sync_every=4, steps_per_loop=8)]


@pytest.mark.parametrize("kw", VGG_CFGS, ids=range(len(VGG_CFGS)))
def test_vgg_config_window_checks_equal_jax(kw):
    """Through each trainer (the port's over a one-rank group, JAX's over
    the 4-device mesh) and through the step builder without a mesh."""
    from distributed_pytorch_tpu_torch.parallel import init as pinit
    cfg = dict(model="TINY", batch_size=4, augment=False, **kw)
    jcfg = jtrain.TrainConfig(**cfg)
    mesh = make_mesh(4) if kw["strategy"] != "none" else None
    want = _outcome(jtrain.Trainer, jcfg, mesh)
    try:
        got = _outcome(ttrain.Trainer, ttrain.TrainConfig(**cfg),
                       device="cpu")
    finally:
        pinit.shutdown()
    assert got == want
    want = _outcome(jtrain.make_multi_step, jcfg, jstrat.get("ddp"), None)
    got = _outcome(ttrain.make_multi_step, ttrain.TrainConfig(**cfg),
                   tstrat.get("ddp"), None)
    assert got == want


def _usage(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    return capsys.readouterr().err.splitlines()[-1].split("error: ", 1)[1]


CLI_ARGV = [["--strategy", "none", "--sync-every", "2"],
            ["--sync-every", "2", "--overlap"],
            ["--outer-opt", "momentum"],
            ["--sync-every", "2", "--outer-opt", "nesterov",
             "--outer-momentum", "1.5"],
            ["--sync-every", "2", "--sync-every-per-slice", "2,4"],
            ["--sync-every", "2", "--sync-every-per-slice", "2,x"],
            ["--max-sync-every", "0"]]


@pytest.mark.parametrize("argv", CLI_ARGV, ids=range(len(CLI_ARGV)))
def test_vgg_cli_window_errors_equal_jax(argv, capsys):
    """Both CLIs end with the same usage error (the sync_every_per_slice
    one: an LM-trainer feature)."""
    assert _usage(tcli.main, ["--device", "cpu"] + argv, capsys) == \
        _usage(jcli.main, argv, capsys)


LM_CLI_ARGV = [["--sync-every", "2"],
               ["--sync-every", "2", "--dcn-size", "2", "--dp", "4",
                "--staleness", "2"],
               ["--sync-every", "2", "--dcn-size", "2", "--dp", "4",
                "--grad-accum", "2"],
               ["--dcn-size", "2", "--dp", "4", "--outer-opt", "nesterov"],
               ["--sync-every", "2", "--dcn-size", "2", "--dp", "4",
                "--sync-every-per-slice", "2,4,4"],
               ["--sync-every", "2", "--dcn-size", "2", "--dp", "4",
                "--sync-every-per-slice", "a"],
               ["--sync-every", "2", "--dcn-size", "2", "--dp", "4",
                "--staleness", "1", "--sync-every-per-slice", "2,4"]]


@pytest.mark.parametrize("argv", LM_CLI_ARGV, ids=range(len(LM_CLI_ARGV)))
def test_lm_cli_window_errors_equal_jax(argv, capsys):
    assert _usage(tlm_cli.main, ["--device", "cpu"] + argv, capsys) == \
        _usage(jlm_cli.main, argv, capsys)


def test_vgg_cli_window_needs_steps_per_loop_as_in_jax(capsys):
    """``--sync-every 2`` at the default ``ddp`` passes the CLI's check,
    and both trainers refuse it with the same message: the CLI leaves
    ``steps_per_loop`` at 1, which a window does not divide."""
    from distributed_pytorch_tpu_torch.parallel import init as pinit
    argv = ["--model", "TINY", "--sync-every", "2"]
    try:
        with pytest.raises(SystemExit) as e:
            tcli.main(["--device", "cpu"] + argv)
    finally:
        pinit.shutdown()
    want = _outcome(jstrat.require_sync_window, sync_every=2,
                    max_sync_every=2, mesh=True, steps_per_loop=1,
                    trainer="train")
    assert str(e.value.code) == want
    assert want.startswith("steps_per_loop=1 is not a multiple of")


# -- lm_cli with the window flags under launch.py ----------------------------------

WINDOW_FLAGS = ["--dcn-size", "2", "--sync-every", "2", "--staleness", "1",
                "--outer-opt", "nesterov", "--outer-momentum", "0.5"]


@pytest.fixture(scope="module")
def cli_window_run(tmp_path_factory):
    """``lm_cli --dp 4`` with the window flags through launch.py on
    tests/test_torch_lm_dp.py's corpus and model."""
    import os
    import subprocess
    import sys

    from distributed_pytorch_tpu_torch.data import lm_corpus as tcorpus
    from test_torch_lm_dp import CLI_MODEL, REPO, _free_port

    def compute():
        corpus = tmp_path_factory.mktemp("window_corpus") / "corpus.txt"
        corpus.write_bytes(tcorpus.synthetic_corpus(40_000, seed=5))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        run = subprocess.run(
            [sys.executable, "-m", "distributed_pytorch_tpu_torch.launch",
             "--nproc-per-node", str(N), "--master-port", str(_free_port()),
             "--", "-m", "distributed_pytorch_tpu_torch.lm_cli",
             "--rendezvous", "env", "--dp", str(N), "--device", "cpu",
             "--corpus", str(corpus)] + CLI_MODEL + WINDOW_FLAGS,
            env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
        return {"rc": np.asarray(run.returncode),
                "out": np.asarray(run.stdout + run.stderr)}
    return shared_result(tmp_path_factory, "torch_diloco_cli", compute)


def _window_losses(run) -> list:
    from test_torch_lm_dp import STEP_LINE
    out = str(run["out"])
    assert int(run["rc"]) == 0, out[-3000:]
    assert all(f"rank {r}/{N}: connected" in out for r in range(N)), out
    assert "| rank 0/4" in out and "| rank 1/4" not in out
    steps = STEP_LINE.findall(out)
    assert [int(s) for s, _ in steps] == [1, 2, 3], steps
    return [float(v) for _, v in steps]


def test_lm_cli_window_flags_under_launch(cli_window_run, cli_run):
    """Every rank trained with the flags; rank 0 alone logged the three
    steps, finite; the first step, taken at the anchor before any window
    exchange, is the flat run's (tests/test_torch_lm_dp.py's ``cli_run``,
    one process on the same global batches), to the log's 4 decimals."""
    losses = _window_losses(cli_window_run)
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], cli_run["want"][0], rtol=0,
                               atol=1e-4)
