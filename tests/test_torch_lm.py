"""The port's LM trainer slice (distributed_pytorch_tpu_torch: lm.py,
lm_cli.py, data/lm_corpus.py, ops/losses.py, convert.py's optimizer state)
against the JAX package's, on the CPU in float32.

The model is tests/test_lm.py's (vocab 256, d_model 128, 2 layers, 2 heads
x 64, d_ff 256; batch 4 x 128, seed 1).  The port starts from the JAX
trainer's own initial params (and, where stated, its mid-run Adam state),
carried by convert.py.  Losses agree to rtol 1e-5 / atol 1e-6; params after
the steps to rtol 1e-4 / atol 5e-4, the bound tests/test_lm.py holds its
own layouts to (Adam divides by sqrt(nu), which amplifies float32
summation-order noise on near-zero gradient entries).

The int8 matmul and the chunked head are held against the JAX package's
forward, head loss and optimizer composed without the mesh
(``_jax_oracle``): on this JAX version the trainer's shard_map'd step does
not trace either option (a custom VJP and a scan whose varying-axis types
do not match), while the unsharded functions run.
"""

import dataclasses
import os
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_pytorch_tpu import lm as jlm
from distributed_pytorch_tpu import lm_cli as jcli
from distributed_pytorch_tpu.utils import telemetry as jtel
from distributed_pytorch_tpu.data import lm_corpus as jcorpus
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu.ops import losses as jlosses
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import lm as tlm
from distributed_pytorch_tpu_torch import lm_cli as tcli
from distributed_pytorch_tpu_torch.data import lm_corpus as tcorpus
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from distributed_pytorch_tpu_torch.ops import losses as tlosses
from distributed_pytorch_tpu_torch.ops import nn as tnn
from distributed_pytorch_tpu_torch.utils import telemetry as ttel

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=5e-4)
SHAPE = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
             head_dim=64, d_ff=256)


def _data(b=4, s=128, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1).astype(np.int32)
    targets[:, -1] = jlm.IGNORE
    return tokens, targets


def _snapshot(jtr):
    return (jax.tree.map(np.array, jtr.params),
            jax.tree.map(np.array, jtr.opt_state))


def _jax_run(steps, batches, model=None, **kw):
    """The JAX trainer's losses, its initial params, and its state after
    every step (numpy copies: the step donates its buffers)."""
    cfg = jlm.LMTrainConfig(model=model or jtfm.TransformerConfig(**SHAPE),
                            compute_dtype=None, **kw)
    jtr = jlm.LMTrainer(cfg)
    states = [_snapshot(jtr)]
    losses = []
    for i in range(steps):
        losses.append(float(jtr.train_step(*batches[i % len(batches)])))
        states.append(_snapshot(jtr))
    return jtr, losses, states


def _jax_oracle(steps, batches, **kw):
    """The JAX single-device step without the mesh: ``jax.value_and_grad``
    of ``head_loss(apply(...)) / n_total`` (flash, the config's
    ``matmul_dtype`` / ``remat`` / head), then the trainer's own optax
    chain; the losses and the params after each step, from the JAX init."""
    cfg = jlm.LMTrainConfig(model=jtfm.TransformerConfig(**SHAPE),
                            compute_dtype=None, **kw)
    params = jtfm.init(jax.random.key(cfg.seed), cfg.model)
    opt = jlm.make_optimizer(cfg)
    opt_state = opt.init(params)

    def loss_fn(p, tokens, targets):
        head = partial(jlosses.head_loss, targets=targets,
                       loss_impl=cfg.loss_impl, loss_chunk=cfg.loss_chunk)
        ce, _ = jtfm.apply(p, tokens, cfg=cfg.model, head_fn=head,
                           matmul_dtype=cfg.matmul_dtype, remat=cfg.remat)
        return ce / jnp.maximum(jnp.sum(targets != jlm.IGNORE), 1)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    losses, states = [], [(jax.tree.map(np.array, params), None)]
    for i in range(steps):
        loss, g = grad_fn(params, *batches[i % len(batches)])
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
        states.append((jax.tree.map(np.array, params), None))
    return losses, states


def _port(states, i=0, with_opt=False, model=None, **kw):
    cfg = tlm.LMTrainConfig(model=model or ttfm.TransformerConfig(**SHAPE),
                            compute_dtype=None, **kw)
    ttr = tlm.LMTrainer(cfg, device="cpu")
    params, opt = states[i]
    ttr.load_state(convert.from_jax_params(params, device="cpu"),
                   convert.from_jax_opt_state(opt, device="cpu")
                   if with_opt else None)
    return ttr


def _assert_params_close(ttr, jparams):
    want = convert.from_jax_params(jparams, device="cpu")
    for name, p in ttr.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   err_msg=name, **PARAM_TOL)


@pytest.fixture(scope="module")
def base():
    """Five JAX steps on two alternating batches."""
    batches = [_data(), _data(seed=1)]
    jtr, losses, states = _jax_run(5, batches)
    return batches, jtr, losses, states


def test_config_fields_match_jax():
    jf = {f.name: f for f in dataclasses.fields(jlm.LMTrainConfig)}
    tf = {f.name: f for f in dataclasses.fields(tlm.LMTrainConfig)}
    assert list(tf) == list(jf)
    for name in jf:
        if name != "model":
            assert tf[name].default == jf[name].default, name
    assert tlm.LMTrainConfig().model == ttfm.PRESETS["LM-tiny"]


def test_trainer_matches_jax(base):
    """Three steps from the JAX initial params: losses and params."""
    batches, _, want, states = base
    ttr = _port(states)
    got = [float(ttr.train_step(*batches[i % 2])) for i in range(3)]
    np.testing.assert_allclose(got, want[:3], **LOSS_TOL)
    _assert_params_close(ttr, states[3][0])
    assert float(ttr.last_ok) == 1.0
    assert ttr.last_metrics.shape == (2,) and ttr._step == 3


def test_continues_from_carried_jax_state(base):
    """The port picks up the JAX run after step 3 (params and Adam state,
    carried by convert.py) and reproduces steps 4 and 5."""
    batches, _, want, states = base
    ttr = _port(states, 3, with_opt=True)
    assert ttr._step == 3
    got = [float(ttr.train_step(*batches[i % 2])) for i in (3, 4)]
    np.testing.assert_allclose(got, want[3:5], **LOSS_TOL)
    _assert_params_close(ttr, states[5][0])


def test_evaluate_matches_jax(base):
    batches, jtr, _, states = base
    ttr = _port(states, 5)
    want = jtr.evaluate(batches)
    got = ttr.evaluate(batches)
    assert got["tokens"] == want["tokens"] == 2 * 4 * 127
    np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)


def test_schedule_and_clip_match_jax():
    """Warmup + cosine decay, and a grad_clip small enough to bite on
    every step."""
    kw = dict(warmup_steps=2, decay_steps=6, lr=1e-3, grad_clip=0.05)
    batches = [_data(seed=2)]
    jtr, want, states = _jax_run(3, batches, **kw)
    assert float(np.asarray(jtr.last_metrics)[0]) > kw["grad_clip"]
    ttr = _port(states, **kw)
    got = [float(ttr.train_step(*batches[0])) for _ in range(3)]
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    _assert_params_close(ttr, states[3][0])


def test_grad_accum_matches_jax():
    """grad_accum=2 on both sides: the interleaved split, gradients summed
    and normalized by the whole batch's token count."""
    tokens, targets = _data(seed=3)
    targets[0, 60:] = jlm.IGNORE  # unequal masks per microbatch
    _, want, states = _jax_run(3, [(tokens, targets)], grad_accum=2)
    ttr = _port(states, grad_accum=2)
    got = [float(ttr.train_step(tokens, targets)) for _ in range(3)]
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    _assert_params_close(ttr, states[3][0])
    with pytest.raises(ValueError, match="divisible into"):
        _port(states, grad_accum=3).train_step(tokens, targets)


@pytest.mark.parametrize("kw", [
    dict(), dict(warmup_steps=5), dict(decay_steps=12),
    dict(warmup_steps=3, decay_steps=12, min_lr_ratio=0.2, lr=1e-3)],
    ids=["constant", "warmup", "cosine", "warmup_cosine"])
def test_lr_sequence_matches_optax(kw):
    """The port's per-step LR against the JAX package's optax schedule,
    evaluated at the update count (0 for the first step)."""
    want_fn = jlm.make_schedule(jlm.LMTrainConfig(**kw))
    got_fn = tlm.make_schedule(tlm.LMTrainConfig(**kw))
    for step in range(16):
        want = want_fn if isinstance(want_fn, float) else float(want_fn(step))
        np.testing.assert_allclose(got_fn(step), want, rtol=1e-6, atol=1e-12)


def test_opt_state_round_trip(base):
    _, _, _, states = base
    params, opt = states[2]
    mine = convert.from_jax_opt_state(opt, device="cpu")
    assert mine["count"] == 2
    back = convert.to_jax_opt_state(mine, like=opt)
    a, b = jax.tree.leaves(opt), jax.tree.leaves(back)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_losses_match_jax():
    """masked_ce and the dense head on shared inputs; the chunked head
    against JAX's ``masked_ce_chunked`` in value (rtol 1e-6 / atol 1e-6: the
    online and one-shot logsumexps round differently) and gradients (rtol
    1e-5 / atol 2e-6: a few float32 ulps of |grad| ~3, summed over the
    chunks in another order) and
    against the dense head, ignored targets included, for the default chunk
    and one that tiles the vocabulary; a chunk that does not divide it is
    a ValueError, as in JAX; the tensor-parallel head names slice 5."""
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 8, 16)).astype(np.float32)
    emb = rng.standard_normal((32, 16)).astype(np.float32)
    tg = rng.integers(0, 32, (2, 8)).astype(np.int32)
    tg[1, 5:] = tnn.IGNORE_INDEX
    want = jlosses.head_loss(h, emb, tg)
    got = tlosses.head_loss(torch.from_numpy(h), torch.from_numpy(emb),
                            torch.from_numpy(tg))
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-6)
    assert int(got[1]) == int(want[1]) == 13
    tol = dict(rtol=1e-6, atol=1e-6)
    for chunk in (None, 8):
        kw = dict(loss_impl="chunked", loss_chunk=chunk)
        jval, (jdh, jde) = jax.value_and_grad(
            lambda a, b: jlosses.head_loss(a, b, tg, **kw)[0],
            argnums=(0, 1))(jnp.asarray(h), jnp.asarray(emb))
        th, te = (torch.from_numpy(a).requires_grad_(True) for a in (h, emb))
        ce, n = tlosses.head_loss(th, te, torch.from_numpy(tg), **kw)
        assert int(n) == 13
        np.testing.assert_allclose(ce.item(), float(jval), **tol)
        np.testing.assert_allclose(ce.item(), got[0].item(), **tol)
        ce.backward()
        gtol = dict(rtol=1e-5, atol=2e-6)
        np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), **gtol)
        np.testing.assert_allclose(te.grad.numpy(), np.asarray(jde), **gtol)
        assert not th.grad[1, 5:].any()  # ignored positions: no gradient
    assert tlosses.default_chunk(32) == jlosses.default_chunk(32) == 32
    assert tlosses.default_chunk(32_000) == jlosses.default_chunk(32_000)
    for mod, arr in ((jlosses, jnp.asarray), (tlosses, torch.from_numpy)):
        with pytest.raises(ValueError, match="divisor"):
            mod.head_loss(arr(h), arr(emb), arr(tg), loss_impl="chunked",
                          loss_chunk=5)
    with pytest.raises(NotImplementedError, match="slice 5"):
        tlosses.head_loss(torch.from_numpy(h), torch.from_numpy(emb),
                          torch.from_numpy(tg), loss_impl="chunked",
                          tp_axis="model", tp_size=2)


def test_corpus_and_loader_match_jax():
    """Same bytes, same encode/decode, and exactly the JAX loader's batches
    for the same seed and epoch, in both shuffle modes and layouts."""
    assert tcorpus.VOCAB_SIZE == jcorpus.VOCAB_SIZE
    assert tcorpus.synthetic_corpus(20_000, seed=3) == \
        jcorpus.synthetic_corpus(20_000, seed=3)
    np.testing.assert_array_equal(tcorpus.encode("héllo"),
                                  jcorpus.encode("héllo"))
    corpus_t = tcorpus.load_corpus(synthetic_bytes=50_000)
    corpus_j = jcorpus.load_corpus(synthetic_bytes=50_000)
    np.testing.assert_array_equal(corpus_t.tokens, corpus_j.tokens)
    assert tcorpus.decode(corpus_t.tokens[:40]) == \
        jcorpus.decode(corpus_j.tokens[:40])
    for kw in (dict(), dict(shuffle_mode="affine"), dict(shuffle=False),
               dict(num_replicas=2, rank=1, elastic_order=True)):
        lt = tcorpus.LMDataLoader(corpus_t, 4, 64, seed=7, **kw)
        lj = jcorpus.LMDataLoader(corpus_j, 4, 64, seed=7, **kw)
        assert len(lt) == len(lj)
        for epoch in (0, 1):
            lt.set_epoch(epoch)
            lj.set_epoch(epoch)
            for (a, b), (c, d) in zip(lt, lj):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, d)


CLI_BASE = ["--device", "cpu", "--d-model", "64", "--n-layers", "1",
            "--n-heads", "1", "--head-dim", "64", "--seq-len", "64",
            "--batch-size", "2", "--log-every", "1"]


def test_lm_cli_runs_on_cpu(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(tcorpus.synthetic_corpus(20_000))
    assert tcli.main(CLI_BASE + ["--steps", "3", "--eval-every", "3",
                                 "--corpus", str(corpus),
                                 "--generate", "The", "--max-new", "4",
                                 "--temperature", "0"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out and out[-1].startswith("The") and len(out[-1]) >= 4


def test_lm_cli_parser_matches_jax():
    jp, tp = jcli.build_parser(), tcli.build_parser()
    jflags = {o: a for a in jp._actions for o in a.option_strings}
    tflags = {o: a for a in tp._actions for o in a.option_strings}
    assert set(tflags) == set(jflags) | {"--device"}
    for flag, action in jflags.items():
        if flag not in ("-h", "--help"):
            assert tflags[flag].default == action.default, flag
    assert tflags["--device"].default == "cuda"


REFUSED_FLAGS = [["--dp", "2"], ["--tp", "2"], ["--pp-size", "2"],
                 ["--fsdp"], ["--elastic"], ["--checkpoint-dir", "ck"],
                 ["--max-nodes", "4"],
                 ["--telemetry-dir", "tel"], ["--profile-dir", "p"],
                 ["--sync-every", "2"], ["--dcn-size", "2"],
                 ["--matmul-dtype", "int8"], ["--loss-impl", "chunked"],
                 ["--remat", "full"], ["--n-experts", "2", "--n-layers", "2"],
                 ["--rendezvous", "env"]]
# ported now: (the trainer config they set, how the run compares with the
# same run without them)
LIFTED_FLAGS = {"--matmul-dtype": dict(matmul_dtype="int8"),
                "--loss-impl": dict(loss_impl="chunked"),
                "--remat": dict(remat="full"),
                "--n-experts": dict(),
                "--dp": dict(),
                "--rendezvous": dict(dp=1)}


def _cli_losses(extra):
    losses = []
    trainer = tcli.run(CLI_BASE + ["--steps", "2"] + extra,
                       on_step=lambda step, tr, loss: losses.append(
                           float(loss)))
    return trainer, losses


@pytest.mark.parametrize("flag", REFUSED_FLAGS, ids=lambda f: f[0])
def test_lm_cli_refuses_later_flags(flag, capsys, tmp_path, monkeypatch,
                                    one_thread):
    """Flags of later slices end the run with a usage error naming the
    slice.  Six are ported now and run instead: the trainer gets the
    knob, and against the same run without it (bf16, two steps) ``--remat
    full`` gives the same losses (the same forward), ``--loss-impl
    chunked`` the same to rtol 1e-4 (the head's float32 sums in another
    order, carried through a bf16 step), and ``--matmul-dtype int8``
    within 1% of them but not equal (the int8 forward ran).
    ``--n-experts 2`` (two layers: layer 1 MoE) trains the MoE model,
    whose losses differ from the dense model's.  ``--rendezvous env``
    without a launcher is a gang of one: its losses are bitwise those of
    the run without a process group, and no group is left after the
    run.  ``--dp 2`` without a gang of two names the launcher (the
    4-rank ``--dp 4`` run is in tests/test_torch_lm_dp.py).  ``--fsdp``
    and ``--dcn-size 2`` are ported: in one process the JAX config checks
    refuse them (ZeRO-3 over a data axis of one rank is a no-op, and one
    rank does not factor into two slices; the 4-rank run of every sync
    flag is tests/test_torch_dcn_sync.py's).  ``--sync-every`` is ported
    too: in one process both CLIs refuse it with the JAX window check's
    usage error (a window needs ``--dcn-size`` >= 2; the 4-rank windows
    are tests/test_torch_localsgd.py's).  ``--telemetry-dir`` and
    ``--profile-dir`` are ported: the losses are bitwise those of the run
    without them; the run directory holds a step span and three gauges a
    step, the loss gauges being the losses the steps returned, and the
    profile directory a torch.profiler trace (of step 2, the run's last
    here).  Their directories are relative to the working directory, a
    temporary one here.  ``--checkpoint-dir`` is ported (slice 5c-ii): the
    losses are bitwise those of the run without it, the directory holds
    the step-2 checkpoint with its loader position, and a 3-step run
    resumes there, its one step's loss bitwise the third loss of an
    uninterrupted 3-step run.  ``--elastic`` and ``--max-nodes`` still
    name slice 5c-iii."""
    if flag[0] == "--sync-every":
        with pytest.raises(SystemExit) as e:
            tcli.main(CLI_BASE + ["--steps", "1"] + flag)
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert "sync_every=2 needs dcn_size >= 2 on the LM trainer" in err
        with pytest.raises(SystemExit) as je:
            jcli.main(CLI_BASE[2:] + ["--steps", "1"] + flag)
        assert je.value.code == 2
        assert err.splitlines()[-1].split("error: ")[1] == \
            capsys.readouterr().err.splitlines()[-1].split("error: ")[1]
        return
    if flag[0] in ("--telemetry-dir", "--profile-dir"):
        from distributed_pytorch_tpu_torch.utils import telemetry
        monkeypatch.chdir(tmp_path)
        _, got = _cli_losses(flag)
        _, want = _cli_losses([])
        assert got == want and telemetry.active() is None
        if flag[0] == "--profile-dir":
            (trace,) = os.listdir(tmp_path / "p")
            assert trace.endswith(".pt.trace.json")
            return
        s = telemetry.run_summary(str(tmp_path / "tel"))
        assert s["spans"]["rank0/train/lm_train_step"]["count"] == 2
        for g in ("loss", "grad_norm", "param_norm"):
            assert s["gauges"][f"rank0/train/{g}"]["count"] == 2
        (_, recs), = telemetry.read_run(str(tmp_path / "tel"))
        assert [r["value"] for r in recs if r["name"] == "loss"] == got
        return
    if flag[0] == "--checkpoint-dir":
        monkeypatch.chdir(tmp_path)
        _, got = _cli_losses(flag)
        _, want = _cli_losses([])
        assert got == want
        from distributed_pytorch_tpu_torch.utils import checkpoint
        flat, meta = checkpoint._load_npz_verified(
            str(tmp_path / "ck" / "ckpt_2.npz"))
        assert meta["step"] == 2 and meta["loader"]["offset"] == 2
        assert flat["opt/count"] == 2
        resumed = []
        tr = tcli.run(CLI_BASE + ["--steps", "3"] + flag,
                      on_step=lambda step, t, loss: resumed.append(
                          float(loss)))
        whole = []
        tcli.run(CLI_BASE + ["--steps", "3"],
                 on_step=lambda step, t, loss: whole.append(float(loss)))
        assert tr.restored_meta["step"] == 2 and resumed == whole[2:]
        return
    if flag[0] in ("--fsdp", "--dcn-size"):
        with pytest.raises(ValueError, match="no-op|does not factor"):
            tcli.main(CLI_BASE + ["--steps", "1"] + flag)
        return
    if flag[0] == "--dp":
        with pytest.raises(NotImplementedError,
                           match="launch --nproc-per-node 2"):
            tcli.main(CLI_BASE + ["--steps", "1"] + flag)
        assert not torch.distributed.is_initialized()
        return
    if flag[0] == "--n-experts":
        trainer, got = _cli_losses(flag)
        assert trainer.cfg.model.n_experts == 2
        assert trainer.cfg.model.is_moe_layer(1)
        assert "layers.1.moe.router" in trainer.params
        _, want = _cli_losses(flag[2:])
        assert all(np.isfinite(got)) and got != want
        return
    if flag[0] in LIFTED_FLAGS:
        trainer, got = _cli_losses(flag)
        for name, value in LIFTED_FLAGS[flag[0]].items():
            assert getattr(trainer.cfg, name) == value
        _, want = _cli_losses([])
        if flag[0] in ("--remat", "--rendezvous"):
            assert got == want
            assert not torch.distributed.is_initialized()
        elif flag[0] == "--loss-impl":
            np.testing.assert_allclose(got, want, rtol=1e-4)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-2)
            assert got != want
        return
    with pytest.raises(SystemExit) as e:
        tcli.main(CLI_BASE + ["--steps", "1"] + flag)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err
    if flag[0] in ("--elastic", "--max-nodes"):
        assert "slice 5c-iii (elastic)" in err


def test_lm_cli_scale_flags_compose_and_check(capsys):
    """``--matmul-dtype int8 --remat selective --loss-impl chunked
    --loss-chunk 64`` train together; ``--loss-chunk`` without the chunked
    head and a chunk that does not divide the vocabulary are refused, as
    in the JAX CLI."""
    trainer, losses = _cli_losses(["--matmul-dtype", "int8", "--remat",
                                   "selective", "--loss-impl", "chunked",
                                   "--loss-chunk", "64"])
    assert (trainer.cfg.matmul_dtype, trainer.cfg.remat,
            trainer.cfg.loss_impl, trainer.cfg.loss_chunk) == \
        ("int8", "selective", "chunked", 64)
    assert len(losses) == 2 and all(np.isfinite(losses))
    with pytest.raises(SystemExit) as e:
        tcli.main(CLI_BASE + ["--steps", "1", "--loss-chunk", "64"])
    assert e.value.code == 2 and "--loss-impl chunked" in \
        capsys.readouterr().err
    with pytest.raises(ValueError, match="divisor"):
        tcli.main(CLI_BASE + ["--steps", "1", "--loss-impl", "chunked",
                              "--loss-chunk", "100"])


@pytest.mark.parametrize("kw", [
    dict(dp=2), dict(fsdp=True), dict(sync_every=2), dict(pp_size=2),
    dict(remat="full"), dict(loss_impl="chunked"), dict(matmul_dtype="int8"),
    dict(model=ttfm.TransformerConfig(**SHAPE, n_experts=2))],
    ids=["dp", "fsdp", "sync_every", "pp_size", "remat", "loss_impl",
         "matmul_dtype", "n_experts"])
def test_trainer_refuses_later_slices(kw):
    """Knobs of later slices raise, naming their ROADMAP slice.
    ``sync_every=2`` is ported: at dp 1 both packages refuse it with the
    same ValueError (a window needs dcn_size >= 2).  ``dp=2`` is ported:
    without a gang
    of two processes it raises, naming the launcher (the gang runs in
    tests/test_torch_lm_dp.py).  So is ``fsdp=True``: at dp 1 both
    packages refuse it as a no-op, and at dp 2 it takes a gang
    (tests/test_torch_fsdp.py runs it in one of four).  Four are
    ported now, and three f32 steps from the JAX initial params are held
    against the JAX package instead:

    - ``n_experts=2`` (layer 1 MoE): the JAX MoE trainer, at the module's
      tolerances;

    - ``remat="full"``: the JAX remat trainer, at the module's tolerances;
    - ``loss_impl="chunked"``: the JAX chunked head through ``_jax_oracle``,
      at the module's tolerances;
    - ``matmul_dtype="int8"``: the JAX int8 forward through ``_jax_oracle``,
      losses at rtol 1e-4 and params within 2 lr x 3 steps.  The two
      packages' activations differ by float32 ulps, and a value an ulp from
      a rounding boundary quantizes one quantum apart (tests/
      test_torch_transformer.py measures it), which moves the loss by about
      1e-5 relative; Adam then moves a parameter whose gradient flips sign
      by up to 2 lr a step."""
    batches = [_data(), _data(seed=1)]
    if kw.get("fsdp"):
        # ported: ZeRO-3 over one rank is refused as in the JAX package,
        # and over two it takes a gang (tests/test_torch_fsdp.py)
        for pkg in (jlm, tlm):
            with pytest.raises(ValueError, match="no-op"):
                pkg.validate_lm_cfg(pkg.LMTrainConfig(**kw))
        with pytest.raises(NotImplementedError,
                           match="launch --nproc-per-node 2"):
            tlm.LMTrainer(tlm.LMTrainConfig(dp=2, **kw), device="cpu")
        return
    if "dp" in kw:
        with pytest.raises(NotImplementedError,
                           match="launch --nproc-per-node 2"):
            tlm.LMTrainer(tlm.LMTrainConfig(**kw), device="cpu")
        return
    if "sync_every" in kw:
        msgs = []
        for pkg in (jlm, tlm):
            with pytest.raises(ValueError, match="dcn_size >= 2") as e:
                pkg.validate_lm_cfg(pkg.LMTrainConfig(**kw))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        with pytest.raises(ValueError, match="dcn_size >= 2"):
            tlm.LMTrainer(tlm.LMTrainConfig(**kw), device="cpu")
        return
    if "model" in kw:
        _, want, states = _jax_run(3, batches, model=jtfm.TransformerConfig(
            **SHAPE, n_experts=2))
    elif "remat" in kw:
        _, want, states = _jax_run(3, batches, **kw)
    elif "loss_impl" in kw or "matmul_dtype" in kw:
        want, states = _jax_oracle(3, batches, **kw)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tlm.LMTrainer(tlm.LMTrainConfig(**kw), device="cpu")
        return
    ttr = _port(states, **kw)
    got = [float(ttr.train_step(*batches[i % 2])) for i in range(3)]
    if "matmul_dtype" in kw:
        np.testing.assert_allclose(got, want, rtol=1e-4)
        want_p = convert.from_jax_params(states[3][0], device="cpu")
        for name, p in ttr.params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want_p[name].numpy(),
                                       atol=2 * ttr.cfg.lr * 3, err_msg=name)
        return
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    _assert_params_close(ttr, states[3][0])


@pytest.mark.parametrize("remat", ["full", "selective"])
def test_remat_grads_equal_no_remat_and_jax(base, remat):
    """A rematerialized step recomputes the same forward: from the JAX
    initial params the port's step-1 loss and every gradient equal the
    no-remat step's (the same float32 operations, in the same order), and
    the losses of three steps match the JAX remat trainer's (``remat=
    "full"`` in test_trainer_refuses_later_slices, ``"selective"`` here)."""
    batches, _, _, states = base
    grads = {}
    for mode in ("none", remat):
        ttr = _port(states, remat=mode)
        loss_fn = partial(tlm._loss_fn, ttr.cfg, "flash")
        tokens, targets = ttr._batch(*batches[0])
        n_total = (targets != tlm.IGNORE).sum().float()
        loss = loss_fn(ttr.params, tokens, targets, n_total, 0.0)
        loss.backward()
        grads[mode] = (loss.item(), {n: p.grad for n, p in
                                     ttr.params.items()})
    assert grads[remat][0] == grads["none"][0]
    for name, g in grads["none"][1].items():
        torch.testing.assert_close(grads[remat][1][name], g, rtol=1e-6,
                                   atol=1e-8)
    if remat == "selective":
        _, want, jstates = _jax_run(3, batches, remat=remat)
        ttr = _port(jstates, remat=remat)
        got = [float(ttr.train_step(*batches[i % 2])) for i in range(3)]
        np.testing.assert_allclose(got, want, **LOSS_TOL)
        _assert_params_close(ttr, jstates[3][0])


def test_scale_knob_values_are_checked_as_in_jax():
    """The value checks of the JAX ``validate_lm_cfg`` for the int8 matmul,
    the chunked head and remat: ValueErrors on both sides."""
    model = dict(model=ttfm.TransformerConfig(**SHAPE))
    jmodel = dict(model=jtfm.TransformerConfig(**SHAPE))
    for kw in (dict(matmul_dtype="int4"), dict(loss_chunk=64),
               dict(loss_impl="chunked", loss_chunk=100),
               dict(loss_impl="chunked", loss_chunk=0), dict(remat="some"),
               dict(loss_impl="sparse")):
        with pytest.raises(ValueError):
            jlm.validate_lm_cfg(jlm.LMTrainConfig(**jmodel, **kw))
        with pytest.raises(ValueError):
            tlm.validate_lm_cfg(tlm.LMTrainConfig(**model, **kw))


def test_trainer_refuses_checkpoints_and_the_cpu_by_default(monkeypatch,
                                                           tmp_path):
    """The checkpoint methods work now (slice 5c-ii): an empty directory
    restores nothing, a save flushed and restored into a fresh trainer
    gives the params, Adam state and step back bitwise.  ``rebuild`` still
    names slice 5c-iii, and without a GPU the default device raises."""
    cfg = tlm.LMTrainConfig(model=ttfm.TransformerConfig(**SHAPE))
    ttr = tlm.LMTrainer(cfg, device="cpu")
    ck = str(tmp_path / "ck")
    assert ttr.maybe_restore(ck) == 0 and ttr.restored_meta == {}
    ttr.train_step(*_data())
    ttr.save_checkpoint(ck, extra_meta={"tag": 7})
    ttr.flush_checkpoints()
    fresh = tlm.LMTrainer(cfg, device="cpu")
    assert fresh.maybe_restore(ck) == 1 and fresh.restored_meta["tag"] == 7
    assert fresh.opt_state["count"] == 1
    for n, p in ttr.params.items():
        assert torch.equal(fresh.params[n], p) and fresh.params[n] \
            .requires_grad
        for m in ("mu", "nu"):
            assert torch.equal(fresh.opt_state[m][n], ttr.opt_state[m][n])
    with pytest.raises(NotImplementedError, match="slice 5c-iii"):
        ttr.rebuild()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.LMTrainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--steps", "1"])


# -- K steps a call, and telemetry ------------------------------------------

@pytest.fixture
def one_thread():
    """Bitwise run-to-run checks pin torch to one intra-op thread: with
    several, the port's CPU step sums in a thread-dependent order (two
    identical 3-step runs of this module's model differ by an ulp)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacked(k, seed=20):
    batches = [_data(seed=seed + i) for i in range(k)]
    return (np.stack([b[0] for b in batches]),
            np.stack([b[1] for b in batches]), batches)


def test_train_steps_is_k_train_steps_bitwise(base, one_thread):
    """``train_steps`` over 3 stacked batches against 3 ``train_step``
    calls from the same state, float32: losses, health flags, metrics,
    params and Adam state bitwise equal; (K,) and (K, 2) shapes."""
    _, _, _, states = base
    tokens, targets, batches = _stacked(3)
    one = _port(states)
    want = [one.train_step(*b) for b in batches]
    many = _port(states)
    got = many.train_steps(tokens, targets)
    assert got.shape == (3,) and many.last_ok.shape == (3,)
    assert many.last_metrics.shape == (3, 2) and many._step == one._step
    np.testing.assert_array_equal(got.numpy(), torch.stack(want).numpy())
    np.testing.assert_array_equal(many.last_metrics[-1].numpy(),
                                  one.last_metrics.numpy())
    for name, p in one.params.items():
        np.testing.assert_array_equal(many.params[name].detach().numpy(),
                                      p.detach().numpy(), err_msg=name)
        for m in ("mu", "nu"):
            np.testing.assert_array_equal(many.opt_state[m][name].numpy(),
                                          one.opt_state[m][name].numpy())
    assert many.opt_state["count"] == one.opt_state["count"] == 3


def test_train_steps_matches_jax(base):
    """Against JAX ``LMTrainer.train_steps`` (its ``lax.scan``) from the
    same initial params: the K losses at the loss tolerance, the params
    within the trainer bands, the health flags and (K, 2) metrics."""
    _, _, _, states = base
    tokens, targets, _ = _stacked(3)
    jtr = jlm.LMTrainer(jlm.LMTrainConfig(
        model=jtfm.TransformerConfig(**SHAPE), compute_dtype=None))
    init = _snapshot(jtr)
    want = np.asarray(jtr.train_steps(tokens, targets))
    ttr = _port([init])
    got = ttr.train_steps(tokens, targets).numpy()
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    _assert_params_close(ttr, jax.tree.map(np.array, jtr.params))
    np.testing.assert_array_equal(ttr.last_ok.numpy(),
                                  np.asarray(jtr.last_ok))
    np.testing.assert_allclose(ttr.last_metrics.numpy(),
                               np.asarray(jtr.last_metrics), rtol=1e-5)


STEPS_REFUSED = [dict(pp=2), dict(pp_size=2), dict(grad_accum=2),
                 dict(dcn_compress="int8"), dict(sync_every=2)]


@pytest.mark.parametrize("kw", STEPS_REFUSED, ids=lambda k: next(iter(k)))
def test_train_steps_refusals_match_jax(kw):
    """The configs the K-step call does not take, refused with the JAX
    trainer's messages word for word (each checked before the trainer
    state is touched, so a stand-in trainer holding only the config is
    enough on both sides)."""
    tokens, targets, _ = _stacked(2)
    msgs = []
    for mod in (jlm, tlm):
        fake = types.SimpleNamespace(cfg=dataclasses.replace(
            mod.LMTrainConfig(), **kw))
        with pytest.raises(ValueError) as e:
            mod.LMTrainer.train_steps(fake, tokens, targets)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "use train_step" in msgs[1]


def _vgg_run(run_dir=None):
    from distributed_pytorch_tpu_torch import train as ttrain
    from distributed_pytorch_tpu_torch.data import cifar10 as tcifar
    if run_dir is not None:
        ttel.enable(run_dir, rank=0)
    try:
        tr = ttrain.Trainer(ttrain.TrainConfig(
            model="TINY", strategy="none", steps_per_loop=2), device="cpu")
        ds = tcifar._synthetic(16, seed=2)
        images = ds.images.reshape(2, 8, 32, 32, 3)
        labels = ds.labels.reshape(2, 8)
        losses = [tr.train_steps(images, labels).numpy() for _ in range(2)]
        return losses, tr.last_metrics.numpy(), {
            f"{k}/{n}": p.detach().numpy() for k, v in tr.params.items()
            for n, p in v.items()}
    finally:
        ttel.disable()


def _lm_run(states, run_dir=None):
    if run_dir is not None:
        ttel.enable(run_dir, rank=0)
    try:
        ttr = _port(states)
        tokens, targets, batches = _stacked(2)
        losses = [ttr.train_step(*b).numpy() for b in batches]
        losses.append(ttr.train_steps(tokens, targets).numpy())
        return losses, ttr.last_metrics.numpy(), {
            n: p.detach().numpy() for n, p in ttr.params.items()}
    finally:
        ttel.disable()


@pytest.mark.parametrize("trainer", ["lm", "vgg"])
def test_telemetry_off_is_bitwise_free(base, trainer, tmp_path, one_thread):
    """Telemetry on and off give bitwise the same losses, metrics and
    params (the LM: two ``train_step`` and one ``train_steps`` call; VGG:
    two ``train_steps`` calls of 2 steps); the run directory holds what
    each call emitted (the LM windows: tests/test_torch_telemetry.py)."""
    if trainer == "lm":
        run = partial(_lm_run, base[3])
        spans = {"lm_train_step": 2, "lm_train_steps": 1}
        build = "lm_step_build"
    else:
        run = _vgg_run
        spans = {"train_steps": 2}
        build = "train_step_build"
    off, on = run(), run(str(tmp_path))
    for a, b in zip(off[0], on[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(off[1], on[1])
    for name in off[2]:
        np.testing.assert_array_equal(off[2][name], on[2][name])
    s = ttel.run_summary(str(tmp_path))
    for name, n in spans.items():
        assert s["spans"][f"rank0/train/{name}"]["count"] == n
    assert s["counters"]["rank0/train/steps"] == 4
    assert s["spans"][f"rank0/compile/{build}"]["count"] == 1
    (_, recs), = ttel.read_run(str(tmp_path))
    assert [r["value"] for r in recs if r["name"] == "loss"] == [
        float(x) for x in np.concatenate([np.ravel(x) for x in on[0]])]


def test_telemetry_gauges_match_jax(base, tmp_path):
    """Three ``train_step`` calls of each trainer from the same params,
    each streaming into its own run: the ``loss``, ``grad_norm`` and
    ``param_norm`` gauges agree at rtol 1e-5, step for step, and the
    records are the JAX package's shape (one span and three gauges a
    step, a ``steps`` counter)."""
    batches, _, _, states = base
    jtel.enable(str(tmp_path / "jax"), rank=0)
    try:
        _jax_run(3, batches)
    finally:
        jtel.disable()
    ttel.enable(str(tmp_path / "port"), rank=0)
    try:
        ttr = _port(states)
        for i in range(3):
            ttr.train_step(*batches[i % 2])
    finally:
        ttel.disable()
    runs = []
    for d in ("jax", "port"):
        (_, recs), = ttel.read_run(str(tmp_path / d))
        runs.append([r for r in recs if r["phase"] == "train"])
    want, got = runs
    assert [(r["type"], r["name"], r.get("args")) for r in got] == \
        [(r["type"], r["name"], r.get("args")) for r in want]
    gauges = [(r["value"], w["value"]) for r, w in zip(got, want)
              if r["type"] == "gauge"]
    assert len(gauges) == 9
    np.testing.assert_allclose(*zip(*gauges), rtol=1e-5)


@pytest.mark.parametrize("mesh", [(2, 2, {}), (4, 2, dict(fsdp=True)),
                                  (4, 2, dict(bucket_mb=0.05)),
                                  (8, 4, dict(fsdp=True, bucket_mb=0.05)),
                                  (4, 4, {})],
                         ids=lambda m: f"dp{m[0]}-dcn{m[1]}-"
                         + "-".join(m[2]) if m[2] else f"dp{m[0]}-dcn{m[1]}")
def test_lm_window_wire_bytes_match_jax(mesh):
    """The LM window's per-boundary payload against JAX
    ``_lm_window_wire_bytes`` on the factored meshes the JAX suite builds
    over its 8 CPU devices (ZeRO-3 and bucketed partitions included)."""
    dp, dcn, kw = mesh
    model = dict(SHAPE, n_layers=2)
    jcfg = jlm.LMTrainConfig(model=jtfm.TransformerConfig(**model), dp=dp,
                             dcn_size=dcn, sync_every=2, **kw)
    tcfg = tlm.LMTrainConfig(model=ttfm.TransformerConfig(**model), dp=dp,
                             dcn_size=dcn, sync_every=2, **kw)
    want = jlm._lm_window_wire_bytes(jcfg, jlm.make_lm_mesh(jcfg))
    assert tlm._lm_window_wire_bytes(tcfg) == want > 0


@pytest.mark.parametrize("strategy,dcn", [("hierarchical", 2), ("ddp", 1),
                                          ("quantized_ring_ef", 1)])
def test_vgg_window_wire_bytes_match_jax(strategy, dcn):
    """The VGG window's per-boundary payload against JAX
    ``Trainer._compute_window_wire_bytes`` (a stand-in holding its four
    inputs: the JAX trainer's own TINY params over a 4-replica mesh):
    the shard-sized dcn hop per bucket for hierarchical, the tree for the
    flat strategies."""
    from distributed_pytorch_tpu import train as jtrain
    from distributed_pytorch_tpu.models import vgg as jvgg
    from distributed_pytorch_tpu.parallel import strategies as jstrat
    from distributed_pytorch_tpu_torch import train as ttrain
    from distributed_pytorch_tpu_torch.models import vgg as tvgg
    from distributed_pytorch_tpu_torch.parallel import strategies as tstrat
    jparams, _ = jvgg.init(jax.random.key(0), "TINY")
    params, _ = tvgg.init(0, "TINY", device="cpu")
    kw = dict(model="TINY", sync_every=2, dcn_size=dcn, strategy=strategy)
    got = []
    for mod, smod, p, leaves in (
            (jtrain, jstrat, jparams, None),
            (ttrain, tstrat, params,
             [params[k][n] for k, n in ttrain.jax_order(params)])):
        st = smod.get(strategy)
        if strategy == "hierarchical":
            st.bucket_bytes = 40_000  # several buckets over TINY
        fake = types.SimpleNamespace(cfg=mod.TrainConfig(**kw), params=p,
                                     n_replicas=4, strategy=st,
                                     _leaves=lambda leaves=leaves: leaves)
        got.append(mod.Trainer._compute_window_wire_bytes(fake))
    assert got[1] == got[0] > 0
    if strategy == "hierarchical":
        assert len(tstrat.make_bucket_plan(leaves, 40_000)) > 1
