"""The port's tensor and sequence parallel LM (models/transformer.py
``tp_axis`` / ``seq_axis``, ops/losses.py's tensor-parallel chunked head,
lm.py ``LMTrainConfig.tp`` / ``sp``, lm_cli.py ``--tp --sp``) against the
JAX package's on the CPU.

The port runs in Gloo gangs of tests/workers/torch_dp_worker.py mode
``tp``: one of 4 ranks and one of 2, each once a session (their ring
results are tests/test_torch_context.py's); the JAX oracles run on the
virtual CPU mesh (conftest.py), each under its own key.  Both sides start
from the JAX ``transformer.init`` of one seed (convert.py), the model TINY
(d_model 64, 4 heads of 16 over 2 kv heads: GQA, so each tp rank repeats
its local kv head; seq 64).

- ``apply`` at tp = 2 (two 2-rank model groups, each rank its Megatron
  shards): logits and every shard's gradient of a fixed cotangent against
  JAX ``apply(tp_axis="model")`` under ``shard_map`` (the gradients of the
  global arrays, cut to the rank's shard): logits rtol 1e-5 / atol 1e-6,
  gradients rtol 1e-5 / atol 2e-6 of the tensor's largest entry (without
  tp the port's and JAX's embedding gradients differ by 1.3e-6 of theirs:
  64 tokens' rows summed in another order); with
  ``matmul_dtype="int8"`` the logits within twice JAX's own one-ulp
  spread plus 1e-4 (``shard_map(check_vma=False)``).
- The tensor-parallel chunked head at tp = 2: the loss, dh and demb
  against JAX ``masked_ce_chunked(tp_axis="model", tp_size=2)`` under
  ``shard_map(check_vma=False)`` (JAX 0.9.0 needs it there) with the
  gradients taken inside, and against the unsharded head; rtol 1e-5.
- ``LMTrainer``, three f32 steps: (tp=2), (sp=2) in both layouts and with
  an MoE layer (2 ranks; each rank routes its chunk's tokens as a group,
  as JAX's size-1 ``model`` branch does),
  (dp=2, tp=2), (sp=2, tp=2), (sp=2, tp=2) with grad_accum=2 and remat
  "full", and the chunked head at (dp=2, tp=2) held against JAX's dense
  head there (JAX's shard_map'd step does not trace the chunked head under
  tp on this JAX version; its own test fails the same way).  Losses rtol
  1e-5; the gathered params rtol 1e-5 / atol 1e-6 for all but 0.1% of each
  tensor's entries and every entry within rtol 1e-4 / atol 5e-4 (the
  trainer bands of tests/test_torch_lm_dp.py); ``evaluate`` rtol 1e-5;
  the last step's grad-norm and param-norm (over the whole leaves: each tp
  shard counted once) rtol 1e-4 of JAX's.  Params are compared
  after three Adam steps, so a gradient off by a factor (a misplaced
  Megatron f/g) shows, not only the loss.
- A tp=2 x dp=2 trainer's whole-tree and sharded checkpoints restore
  bitwise into fresh trainers, whose next step equals the uninterrupted
  run's.
- ``lm_cli --tp 2 --sp 2`` under ``launch.py --nproc-per-node 4`` logs the
  losses of one process training the same batches (rtol 1e-4: the log's
  four decimals).
- The refusals of slices 5d-i-b, 5d-ii and 5d-iii, each named.
"""

import os
import re
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from distributed_pytorch_tpu import lm as jlm
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu.ops import losses as jlosses
from distributed_pytorch_tpu.utils.compat import shard_map
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import lm as tlm
from distributed_pytorch_tpu_torch import lm_cli as tcli
from distributed_pytorch_tpu_torch.data import lm_corpus as tcorpus
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from distributed_pytorch_tpu_torch.ops import losses as tlosses
from workers.torch_dp_worker import run_gang, shared_result

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=128)
B, S, STEPS = 4, 64, 3
RING = (2, 2, 64, 16)  # B, H, S, D of the ring's whole q/k/v
HEAD_CHUNK = 32
MOE = dict(n_experts=4)  # layer 1 MoE (moe_every 2), top-1
TRAINER = {
    "2": {"tp2": dict(tp=2), "sp2_zigzag": dict(sp=2),
          "sp2_contiguous": dict(sp=2, seq_layout="contiguous"),
          "sp2_moe": dict(sp=2, model=MOE)},
    "4": {"dp2_tp2": dict(dp=2, tp=2), "sp2_tp2": dict(sp=2, tp=2),
          "sp2_tp2_accum_remat": dict(sp=2, tp=2, grad_accum=2,
                                      remat="full"),
          "dp2_tp2_chunked": dict(dp=2, tp=2, loss_impl="chunked")},
}
# the JAX run each case is held against: its own, but the chunked head's,
# JAX's dense head at the same mesh
ORACLE = {"dp2_tp2_chunked": "dp2_tp2"}
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_FAR_SHARE = 1e-3
PARAM_TOL_ALL = dict(rtol=1e-4, atol=5e-4)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**kw):
    return jtfm.TransformerConfig(**dict(MODEL, **kw))


def _init(**kw) -> dict:
    """The JAX trainer's initial params (``tfm.init`` of seed 1), as the
    port's flat dict of arrays (``kw``: the model's overrides)."""
    tree = jtfm.init(jax.random.key(1), _jcfg(**kw))
    return {k: v.numpy() for k, v in convert.from_jax_params(
        jax.tree.map(np.asarray, tree), device="cpu").items()}


def _batches():
    rng = np.random.default_rng(19)
    tokens = rng.integers(0, MODEL["vocab_size"], (STEPS, B, S))
    targets = np.roll(tokens, -1, axis=2)
    targets[:, :, -1] = jlm.IGNORE
    targets[:, 1, 40:] = jlm.IGNORE  # data rank 0 holds fewer valid tokens
    return tokens.astype(np.int32), targets.astype(np.int32)


def gang_inputs() -> dict:
    """Every input of the ``tp`` gang: the ring's whole q/k/v and
    cotangent, the params, the batches, apply's tokens and cotangent, and
    the head's operands."""
    rng = np.random.default_rng(7)
    v = MODEL["vocab_size"]
    out = {f"ring/{x}": rng.standard_normal(RING).astype(np.float32)
           for x in ("q", "k", "v", "g")}
    out.update({f"p/{k}": a for k, a in _init().items()})
    out.update({f"pmoe/{k}": a for k, a in _init(**MOE).items()})
    out["tokens"], out["targets"] = _batches()
    out["apply/tokens"] = rng.integers(0, v, (2, 32)).astype(np.int32)
    out["apply/g"] = rng.standard_normal((2, 32, v)).astype(np.float32)
    out["head/h"] = rng.standard_normal((2, 16, 64)).astype(np.float32)
    out["head/emb"] = (0.1 * rng.standard_normal((v, 64))).astype(np.float32)
    tg = rng.integers(0, v, (2, 16))
    tg[1, 10:] = jlm.IGNORE
    out["head/targets"] = tg.astype(np.int32)
    out["head/chunk"] = np.asarray(HEAD_CHUNK)
    return out


def gang(tmp_path_factory) -> dict:
    """The 4- and 2-rank ``tp`` gangs' outputs, ``"w<world>r<rank>:key"``,
    once a session."""
    def compute():
        out = {}
        for world in (4, 2):
            base = str(tmp_path_factory.mktemp(f"tp_gang{world}"))
            ranks = run_gang("tp", gang_inputs(), base, world=world,
                             cases={"model": MODEL, "trainer": TRAINER,
                                    "steps": STEPS,
                                    "dir": os.path.join(base, "ck")})
            out.update({f"w{world}r{r}:{k}": v for r, o in enumerate(ranks)
                        for k, v in o.items()})
        return out
    return shared_result(tmp_path_factory, "torch_tp_gang", compute)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return gang(tmp_path_factory)


def _close_params(got, want, key):
    np.testing.assert_allclose(got, want, err_msg=key, **PARAM_TOL_ALL)
    far = ~np.isclose(got, want, **PARAM_TOL)
    assert far.mean() <= PARAM_FAR_SHARE, (key, int(far.sum()))


# -- shard_specs ---------------------------------------------------------------

def test_shard_specs_match_jax():
    """Each leaf's split over ``model`` is JAX's ``shard_specs``'s, for a
    dense and an MoE model."""
    for kw in (MODEL, dict(MODEL, n_experts=4)):
        jspecs = jtfm.shard_specs(jtfm.TransformerConfig(**kw),
                                  tp_axis="model")
        flat = convert.from_jax_params(jax.tree.map(
            lambda s: np.zeros(()), jspecs,
            is_leaf=lambda s: isinstance(s, P)), device="cpu")
        tspecs = ttfm.shard_specs(ttfm.TransformerConfig(**kw))
        assert sorted(tspecs) == sorted(flat)
        for name in tspecs:
            path = tlm.jax_path(name)
            node = jspecs
            for part in path:
                node = node[part]
            assert tspecs[name] == tuple(node), name


# -- apply at tp = 2 -----------------------------------------------------------

def _jax_apply() -> dict:
    cfg = _jcfg()
    data = gang_inputs()
    params = jtfm.init(jax.random.key(1), cfg)
    specs = jtfm.shard_specs(cfg, tp_axis="model")
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    fwd = shard_map(partial(jtfm.apply, cfg=cfg, tp_axis="model"),
                    mesh=mesh, in_specs=(specs, P()), out_specs=P())
    toks = jnp.asarray(data["apply/tokens"])
    g = jnp.asarray(data["apply/g"])

    @jax.jit  # one program: eager shard_map dispatch costs more
    def fwd_bwd(params):
        logits, pull = jax.vjp(lambda p: fwd(p, toks), params)
        return logits, pull(g)[0]

    logits, grads = fwd_bwd(params)
    out = {"logits": np.asarray(logits)}
    out.update({f"grad/{k}": v.numpy() for k, v in convert.from_jax_params(
        jax.tree.map(np.asarray, grads), device="cpu").items()})
    return out


@pytest.fixture(scope="module")
def jax_apply(tmp_path_factory):
    return shared_result(tmp_path_factory, "torch_tp_jax_apply", _jax_apply)


@pytest.mark.parametrize("rank", range(4))
def test_apply_tp2_matches_jax(port, jax_apply, rank):
    """Each rank's logits equal JAX's, and each shard's gradient is JAX's
    global gradient cut to the rank's shard (a replicated leaf's whole):
    the explicit f/g pair gives the norms and the embedding their whole
    gradient on every rank."""
    np.testing.assert_allclose(port[f"w4r{rank}:apply/logits"],
                               jax_apply["logits"], **FWD_TOL)
    specs = ttfm.shard_specs(ttfm.TransformerConfig(**MODEL))
    m = rank % 2
    for name, spec in specs.items():
        want = jax_apply[f"grad/{name}"]
        dim = ttfm.tp_dim(spec)
        if dim is not None:
            w = want.shape[dim] // 2
            want = np.take(want, np.arange(m * w, (m + 1) * w), axis=dim)
        np.testing.assert_allclose(port[f"w4r{rank}:apply/grad/{name}"],
                                   want, err_msg=name, rtol=1e-5,
                                   atol=2e-6 * np.abs(want).max())


def _jax_int8_apply() -> dict:
    """JAX ``apply(tp_axis="model", matmul_dtype="int8")`` under
    ``shard_map(check_vma=False)`` (JAX 0.9.0 needs it with int8), and its
    spread: the largest logit move when the embedding moves by one ulp
    (four random sign patterns)."""
    cfg = _jcfg()
    params = jtfm.init(jax.random.key(1), cfg)
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    fwd = jax.jit(shard_map(
        partial(jtfm.apply, cfg=cfg, tp_axis="model", matmul_dtype="int8"),
        mesh=mesh, in_specs=(jtfm.shard_specs(cfg, tp_axis="model"), P()),
        out_specs=P(), check_vma=False))
    toks = jnp.asarray(gang_inputs()["apply/tokens"])
    want = np.asarray(fwd(params, toks))
    embed = np.asarray(params["embed"])
    spread = 0.0
    for seed in range(4):
        sign = np.random.default_rng(seed).choice([-1, 1], embed.shape)
        moved = dict(params, embed=jnp.asarray(np.nextafter(
            embed, embed + sign.astype(np.float32))))
        spread = max(spread,
                     float(np.abs(np.asarray(fwd(moved, toks)) - want).max()))
    return {"logits": want, "spread": np.asarray(spread)}


@pytest.fixture(scope="module")
def jax_int8(tmp_path_factory):
    return shared_result(tmp_path_factory, "torch_tp_jax_int8",
                         _jax_int8_apply)


@pytest.mark.parametrize("rank", range(4))
def test_int8_apply_tp2_matches_jax(port, jax_apply, jax_int8, rank):
    """``matmul_dtype="int8"`` at tp = 2: each rank's products run at its
    shard shapes (wo's input rows, and so its row scales, span the rank's
    heads only, as in JAX's per-shard program), and the logits are JAX's
    within twice the JAX package's own one-ulp spread plus 1e-4
    (tests/test_torch_transformer.py's int8 bound: an ulp of activation
    difference moves a value one quantum); int8 ran (the logits are not
    the plain ones)."""
    got = port[f"w4r{rank}:apply/int8_logits"]
    assert np.abs(got - jax_int8["logits"]).max() <= \
        2 * float(jax_int8["spread"]) + 1e-4
    assert not np.allclose(got, jax_apply["logits"], atol=1e-3)


# -- the tensor-parallel chunked head -----------------------------------------

def _jax_head() -> dict:
    data = gang_inputs()
    h, emb, tg = (jnp.asarray(data[f"head/{x}"])
                  for x in ("h", "emb", "targets"))
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))

    def local(h, emb, tg):
        def loss(h, emb):
            return jlosses.masked_ce_chunked(h, emb, tg, chunk=HEAD_CHUNK,
                                             tp_axis="model", tp_size=2)[0]
        ce, (dh, demb) = jax.value_and_grad(loss, argnums=(0, 1))(h, emb)
        return ce, dh, demb

    ce, dh, demb = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=(P(), P(), P()), check_vma=False))(h, emb, tg)
    plain = jax.jit(jax.value_and_grad(
        lambda h, emb: jlosses.masked_ce_chunked(
            h, emb, tg, chunk=HEAD_CHUNK)[0], argnums=(0, 1)))(h, emb)
    return {"ce": np.asarray(ce), "dh": np.asarray(dh),
            "demb": np.asarray(demb), "plain_ce": np.asarray(plain[0]),
            "plain_dh": np.asarray(plain[1][0]),
            "plain_demb": np.asarray(plain[1][1])}


@pytest.fixture(scope="module")
def jax_head(tmp_path_factory):
    return shared_result(tmp_path_factory, "torch_tp_jax_head", _jax_head)


@pytest.mark.parametrize("rank", range(4))
def test_tp_chunked_head_matches_jax(port, jax_head, rank):
    """The loss, dh and demb (replicated on both ranks of a model group)
    against JAX's tensor-parallel head and its unsharded head."""
    assert int(port[f"w4r{rank}:head/n"]) == 2 * 16 - 6
    for tag, want in (("", "ce"), ("plain_", "ce")):
        np.testing.assert_allclose(port[f"w4r{rank}:head/ce"],
                                   jax_head[tag + want], rtol=1e-5)
    for x in ("dh", "demb"):
        for tag in ("", "plain_"):
            np.testing.assert_allclose(port[f"w4r{rank}:head/{x}"],
                                       jax_head[tag + x], rtol=1e-5,
                                       atol=1e-7, err_msg=tag + x)


# -- the trainer ---------------------------------------------------------------

def _jax_trainer(name: str, cfg_kw: dict) -> dict:
    tokens, targets = _batches()
    cfg_kw = dict(cfg_kw)
    model = _jcfg(**cfg_kw.pop("model", {}))
    tr = jlm.LMTrainer(jlm.LMTrainConfig(model=model, compute_dtype=None,
                                         **cfg_kw))
    losses = [float(tr.train_step(tokens[i], targets[i]))
              for i in range(STEPS)]
    out = {"losses": np.asarray(losses),
           "met": np.asarray(tr.last_metrics)}
    out.update({f"p/{k}": v.numpy() for k, v in convert.from_jax_params(
        jax.tree.map(np.asarray, tr.params), device="cpu").items()})
    ev = tr.evaluate([(tokens[0], targets[0])])
    out["eval"] = np.asarray([ev["loss"], ev["tokens"]])
    return out


CASES = [(w, n) for w in TRAINER for n in TRAINER[w]]


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory, port):
    def oracle(name):
        src = ORACLE.get(name, name)
        kw = next(c[src] for c in TRAINER.values() if src in c)
        return shared_result(tmp_path_factory, f"torch_tp_jax_{src}",
                             lambda: _jax_trainer(src, kw))
    return port, oracle


@pytest.mark.parametrize("world,name", CASES,
                         ids=[n for _, n in CASES])
def test_trainer_matches_jax(trainer_runs, world, name):
    """Every rank's three losses and gathered params against JAX's
    trainer at the same mesh, and ``evaluate`` on each data rank's rows
    of the first batch against JAX's on the whole batch."""
    port, oracle = trainer_runs
    want = oracle(name)
    for r in range(int(world)):
        pre = f"w{world}r{r}:tr/{name}"
        np.testing.assert_allclose(port[f"{pre}/losses"], want["losses"],
                                   **LOSS_TOL)
        np.testing.assert_allclose(port[f"{pre}/eval"], want["eval"],
                                   **LOSS_TOL)
        np.testing.assert_allclose(port[f"{pre}/met"], want["met"],
                                   rtol=1e-4)
        keys = sorted(k for k in want if k.startswith("p/"))
        assert keys
        for k in keys:
            _close_params(port[f"{pre}/{k}"], want[k], f"{name} {k}")
            np.testing.assert_array_equal(port[f"{pre}/{k}"],
                                          port[f"w{world}r0:tr/{name}/{k}"])


@pytest.mark.parametrize("fmt", ["whole", "sharded"])
def test_tp_checkpoint_restores_bitwise(port, fmt):
    """The tp=2 x dp=2 trainer's checkpoint (the whole-tree one gathers
    the ``model`` shards; the sharded one writes each shard once a data
    group) restores every rank's shards of params and moments bitwise,
    and the restored trainer's next step is the uninterrupted one's."""
    for r in range(4):
        pre = f"w4r{r}:ckpt"
        assert int(port[f"{pre}/{fmt}/step"]) == 2
        assert bool(port[f"{pre}/{fmt}/equal"])
        np.testing.assert_array_equal(port[f"{pre}/{fmt}/cont"],
                                      port[f"{pre}/cont"])


# -- the refusals ----------------------------------------------------------------

COMPOSE = [dict(dp=2, fsdp=True), dict(dp=2, dcn_size=2),
           dict(dp=2, fsdp=True, overlap=True),
           dict(dp=2, dcn_size=2, sync_every=2),
           dict(dp=2, dcn_size=2, sync_every=2, staleness=1),
           dict(dp=2, dcn_size=2, sync_every=2, outer_opt="nesterov")]


@pytest.mark.parametrize("kw", COMPOSE, ids=["fsdp", "dcn_size", "overlap",
                                             "sync_every", "staleness",
                                             "outer_opt"])
@pytest.mark.parametrize("axis", ["tp", "sp"])
def test_compositions_left_to_5d_i_b(kw, axis):
    """What composes with tp / sp in the JAX package and is left to
    ROADMAP slice 5d-i-b raises ``NotImplementedError`` naming it, once
    the JAX package's own checks pass (JAX takes each of these)."""
    cfg = dict(kw, **{axis: 2})
    jlm.validate_lm_cfg(jlm.LMTrainConfig(**cfg))
    knob = [k for k in kw if k != "dp"][-1]
    with pytest.raises(NotImplementedError, match="slice 5d-i-b") as e:
        tlm.validate_lm_cfg(tlm.LMTrainConfig(**cfg))
    assert knob in str(e.value)


def test_moe_under_tp_left_to_5d_iii():
    """MoE under a tensor axis (the experts over ``model``, JAX's round-2
    layout) raises naming slice 5d-iii; under ``sp`` alone it is the
    local MoE layer and is taken."""
    moe = ttfm.TransformerConfig(**dict(MODEL, n_experts=4))
    with pytest.raises(NotImplementedError, match="slice 5d-iii"):
        tlm.validate_lm_cfg(tlm.LMTrainConfig(model=moe, tp=2))
    tlm.validate_lm_cfg(tlm.LMTrainConfig(model=moe, sp=2))


def test_cli_refusals_name_their_slices():
    """``--elastic`` under ``--tp`` / ``--sp`` names 5d-i-b and
    ``--generate`` under ``--tp`` names 5d-ii (the JAX CLI's
    ``generate_tp``), before any rendezvous; ``--generate`` under ``--sp``
    alone is taken (rank 0 generates from its replicated params)."""
    base = ["--device", "cpu", "--steps", "1"]
    with pytest.raises(NotImplementedError, match="slice 5d-i-b"):
        tcli.main(base + ["--tp", "2", "--elastic", "--checkpoint-dir",
                          "ck"])
    with pytest.raises(NotImplementedError, match="slice 5d-i-b"):
        tcli.main(base + ["--sp", "2", "--elastic", "--checkpoint-dir",
                          "ck"])
    with pytest.raises(NotImplementedError, match="slice 5d-ii"):
        tcli.main(base + ["--tp", "2", "--generate", "The"])
    args = tcli.build_parser().parse_args(base + ["--sp", "2",
                                                  "--generate", "The"])
    tcli.refuse_model_parallel_flags(args)
    assert not torch.distributed.is_initialized()


def test_trainer_refusals():
    """``LMTrainer.rebuild`` under tp / sp names 5d-i-b (a resize is the
    elastic slice's, left there), the heads and kv heads must divide over
    tp (JAX's messages), and the layout and the chunked head's vocabulary
    checks are JAX's."""
    for kw, msg in ((dict(tp=3), "n_heads 4 must divide over tp=3"),
                    (dict(tp=4), "n_kv_heads 2 must divide over tp=4"),
                    (dict(sp=2, seq_layout="ring"), "layout must be"),
                    (dict(tp=2, loss_impl="chunked", loss_chunk=48),
                     r"per-rank vocab rows \(64 = 128 // tp=2\)")):
        cfgs = [pkg.LMTrainConfig(model=m(**MODEL), **kw) for pkg, m in (
            (jlm, jtfm.TransformerConfig), (tlm, ttfm.TransformerConfig))]
        with pytest.raises(ValueError, match=msg):
            tlm.validate_lm_cfg(cfgs[1])
        if "seq_layout" not in kw:
            with pytest.raises(ValueError, match=msg):
                jlm.validate_lm_cfg(cfgs[0])
    tr = object.__new__(tlm.LMTrainer)
    tr.cfg = tlm.LMTrainConfig(model=ttfm.TransformerConfig(**MODEL), tp=2)
    with pytest.raises(NotImplementedError, match="slice 5d-i-b"):
        tr.rebuild(grad_clip=0.5)


# -- lm_cli --tp 2 --sp 2 under launch.py ---------------------------------------

CLI_MODEL = ["--d-model", "64", "--n-layers", "2", "--n-heads", "4",
             "--n-kv-heads", "2", "--head-dim", "16", "--seq-len", "64",
             "--batch-size", "4", "--compute-dtype", "float32",
             "--steps", "3", "--log-every", "1", "--seed", "3"]
STEP_LINE = re.compile(r"step (\d+) \| loss ([0-9.]+)")


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``lm_cli --rendezvous env --sp 2 --tp 2`` through launch.py on a
    40 KB corpus, and the same run in one process."""
    from test_torch_lm_dp import _free_port

    def compute():
        corpus = tmp_path_factory.mktemp("tp_corpus") / "corpus.txt"
        corpus.write_bytes(tcorpus.synthetic_corpus(40_000, seed=5))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        run = subprocess.run(
            [sys.executable, "-m", "distributed_pytorch_tpu_torch.launch",
             "--nproc-per-node", "4", "--master-port", str(_free_port()),
             "--", "-m", "distributed_pytorch_tpu_torch.lm_cli",
             "--rendezvous", "env", "--dp", "1", "--sp", "2", "--tp", "2",
             "--device", "cpu", "--corpus", str(corpus)] + CLI_MODEL,
            env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
        want = []
        tcli.run(["--device", "cpu", "--corpus", str(corpus)] + CLI_MODEL,
                 on_step=lambda step, tr, loss: want.append(float(loss)))
        return {"rc": np.asarray(run.returncode),
                "out": np.asarray(run.stdout + run.stderr),
                "want": np.asarray(want)}
    return shared_result(tmp_path_factory, "torch_tp_cli", compute)


def test_lm_cli_tp2_sp2_under_launch(cli_run):
    """Four ranks trained (rendezvous lines), rank 0 alone logged the
    three steps, and its losses are one process's on the same batches."""
    out = str(cli_run["out"])
    assert int(cli_run["rc"]) == 0, out[-3000:]
    assert all(f"rank {r}/4: connected" in out for r in range(4)), out
    steps = STEP_LINE.findall(out)
    assert [int(s) for s, _ in steps] == [1, 2, 3], steps
    np.testing.assert_allclose([float(v) for _, v in steps],
                               cli_run["want"], rtol=1e-4)
