"""The port's ZeRO-3 LM trainer (distributed_pytorch_tpu_torch/lm.py with
``fsdp``) against the JAX package's, on the CPU.

The port's ``LMTrainer(dp=4, fsdp=True)`` runs in a 4-rank Gloo gang
(tests/workers/torch_dp_worker.py, mode ``lm``); the JAX one on the
4-device CPU mesh.  Both start from the JAX initial params and take three
float32 steps on tests/test_torch_lm_dp.py's global batch (rank r takes
rows [2r, 2r + 2); rank 1 holds fewer valid targets).  Cases: the dense
model, the MoE model (4 experts, layer 1), the int8 and int4 gathers
(``fsdp_gather_dtype``), ``grad_accum=2``, and ``overlap=True`` (the
gathers and reduce-scatters streamed per layer group), whose oracle is the
JAX non-overlapped run, as the JAX package pins its own overlapped run
bitwise to it.

Held: every rank's shards at construction bitwise JAX's shards of the
same device (the ZeRO-3 dim is the JAX ``param_specs``'s); the losses at
rtol 1e-5; the gathered params after the steps in tests/
test_torch_lm_dp.py's band (rtol 1e-5 / atol 1e-6 for all but 0.1% of
each tensor's entries, every entry within rtol 1e-4 / atol 5e-4: Adam
amplifies float32 summation-order noise on near-zero gradients), and the
four ranks' gathered params bitwise equal; ``evaluate`` (through the
gathers) at rtol 1e-5.  The quantized gathers round each weight to a
level of its row's scale: a weight an ulp of float32 noise from a rounding
boundary lands one level apart in the two packages, which moves a loss by
~1e-6 relative at int8 and ~1e-5 at int4 and, through Adam, a parameter
by up to lr a step.  So their losses are held at rtol 1e-4 and their
params in a band below a trajectory's own movement (Adam moves each
entry ~lr a step: 9.3e-4 to 9.9e-4 over the 3 steps): every entry within
lr / 2, and all but 0.1% of each tensor's entries within the band of the
unquantized cases (rtol 1e-5 / atol 1e-6).  Measured: at most 1.03e-5
(int8) and 4.8e-6 (int4) apart, 0.012% of a tensor's entries outside the
unquantized band; tests/test_torch_dcn_sync.py's compressed rings, at
most 7.9e-5 and 0.061%.  A port that never stepped, or stepped the wrong
way, would sit ~3 lr away.  The overlapped run is bitwise the port's
non-overlapped one (the same collectives on the same tensors, moved).
"""

import jax
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import lm as jlm
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import lm as tlm
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from workers.torch_dp_worker import run_gang, shared_result

N = 4
STEPS = 3
SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=1,
             head_dim=64, d_ff=128)
MOE = dict(SHAPE, n_experts=4)
CASES = {
    "fsdp": dict(model=SHAPE, cfg=dict(fsdp=True)),
    "fsdp_moe": dict(model=MOE, cfg=dict(fsdp=True)),
    "fsdp_int8": dict(model=SHAPE, cfg=dict(fsdp=True,
                                            fsdp_gather_dtype="int8")),
    "fsdp_int4": dict(model=SHAPE, cfg=dict(fsdp=True,
                                            fsdp_gather_dtype="int4")),
    "fsdp_grad_accum2": dict(model=SHAPE, cfg=dict(fsdp=True,
                                                   grad_accum=2)),
    "fsdp_overlap": dict(model=SHAPE, cfg=dict(fsdp=True, overlap=True)),
}
# the JAX run each port case is held against
ORACLE = {"fsdp_overlap": "fsdp"}
QUANTIZED = ("fsdp_int8", "fsdp_int4")
LOSS_TOL = dict(rtol=1e-5)
QUANT_LOSS_TOL = dict(rtol=1e-4)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_FAR_SHARE = 1e-3
PARAM_TOL_ALL = dict(rtol=1e-4, atol=5e-4)
LR = 3e-4  # the LMTrainConfig default both packages train at
QUANT_PARAM_ATOL = LR / 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 256, (2 * N, 64)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1).astype(np.int32)
    targets[:, -1] = jlm.IGNORE
    targets[2:4, 48:] = jlm.IGNORE  # rank 1 holds fewer valid tokens
    return tokens, targets


def _init(model: dict) -> dict:
    """The JAX trainer's initial params (``tfm.init`` at its seed, 1), as
    the port's flat dict of numpy arrays."""
    tree = jtfm.init(jax.random.key(1), jtfm.TransformerConfig(**model))
    return {k: v.numpy() for k, v in convert.from_jax_params(
        jax.tree.map(np.asarray, tree), device="cpu").items()}


def _flat_names(tree) -> dict:
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        else:
            out[convert._flat_name(path)] = node
    walk(tree, [])
    return out


def jax_run(name: str, case: dict) -> dict:
    """The JAX trainer of ``case`` on the 4-device mesh: its initial params
    and each device's initial shards, the losses, the params after the
    steps, the Adam moments and ``evaluate``."""
    tokens, targets = _batch()
    cfg = jlm.LMTrainConfig(model=jtfm.TransformerConfig(**case["model"]),
                            compute_dtype=None, dp=N, **case.get("cfg", {}))
    tr = jlm.LMTrainer(cfg)
    out = {}
    devices = list(tr.mesh.devices.flat)
    for k, arr in _flat_names(tr.params).items():
        out[f"init/{k}"] = np.asarray(arr)
        for r, dev in enumerate(devices):
            (shard,) = [s.data for s in arr.addressable_shards
                        if s.device == dev]
            out[f"shard0/rank{r}/{k}"] = np.asarray(shard)
    out["losses"] = np.asarray(
        [float(tr.train_step(tokens, targets)) for _ in range(STEPS)])
    out.update({f"p/{k}": np.asarray(v)
                for k, v in _flat_names(tr.params).items()})
    adam = [s for s in jax.tree.leaves(
        tr.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    for m in ("mu", "nu"):
        out.update({f"{m}/{k}": np.asarray(v) for k, v in
                    _flat_names(getattr(adam[0], m)).items()})
    out["met"] = np.asarray(tr.last_metrics)
    ev = tr.evaluate([(tokens, targets)])
    out["eval"] = np.asarray([ev["loss"], ev["tokens"]])
    if tr.sync_state is not None:
        out["sync_state"] = np.asarray(tr.sync_state)
    return out


def port_gang(tmp_path_factory, cases: dict, tag: str) -> dict:
    """The port's gang over every case of ``cases``, each from the JAX
    initial params of its model: ``rank{r}:{case}/...`` arrays."""
    tokens, targets = _batch()
    out = {}
    models = {}
    for name, case in cases.items():
        models.setdefault(tuple(sorted(case["model"].items())), []).append(
            name)
    for key, names in models.items():
        inputs = {"tokens": tokens, "targets": targets}
        inputs.update({f"p/{k}": v for k, v in _init(dict(key)).items()})
        ranks = run_gang(
            "lm", inputs, str(tmp_path_factory.mktemp(f"{tag}_gang")),
            world=N, cases={n: dict(cases[n], steps=STEPS) for n in names})
        out.update({f"rank{r}:{k}": v for r, o in enumerate(ranks)
                    for k, v in o.items()})
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return shared_result(tmp_path_factory, "torch_fsdp_port",
                         lambda: port_gang(tmp_path_factory, CASES, "fsdp"))


def _jax(tmp_path_factory, name: str) -> dict:
    oracle = ORACLE.get(name, name)
    return shared_result(tmp_path_factory, f"torch_fsdp_jax_{oracle}",
                         lambda: jax_run(oracle, CASES[oracle]))


def assert_params_in_band(got: np.ndarray, want: np.ndarray, k: str,
                          quantized: bool = False):
    """The params' band; ``quantized`` (a gather or a ring that rounds to
    levels): every entry within ``QUANT_PARAM_ATOL`` instead."""
    if quantized:
        np.testing.assert_allclose(got, want, rtol=0, atol=QUANT_PARAM_ATOL,
                                   err_msg=k)
    else:
        np.testing.assert_allclose(got, want, err_msg=k, **PARAM_TOL_ALL)
    far = ~np.isclose(got, want, **PARAM_TOL)
    assert far.mean() <= PARAM_FAR_SHARE, (k, int(far.sum()))


def test_param_specs_equal_jax():
    """The ZeRO-3 dim of every leaf (the first dim on no other axis that
    the slice-local data size divides) and the size-1 tensor axis entries
    are JAX ``param_specs``'s, at dp 4 and at dp 4 over 2 slices."""
    for kw in (dict(dp=4, fsdp=True), dict(dp=4, dcn_size=2, fsdp=True),
               dict(dp=4)):
        for model in (SHAPE, MOE):
            want = _flat_names(jlm.param_specs(jlm.LMTrainConfig(
                model=jtfm.TransformerConfig(**model), **kw)))
            got = tlm.param_specs(tlm.LMTrainConfig(
                model=ttfm.TransformerConfig(**model), **kw))
            shapes = tlm.param_shapes(ttfm.TransformerConfig(**model))
            assert sorted(got) == sorted(want)
            for k, spec in want.items():
                full = tuple(spec) + (None,) * (len(shapes[k]) - len(spec))
                assert got[k] == full, (k, got[k], full)
    init = ttfm.init(0, ttfm.TransformerConfig(**MOE), device="cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        tlm.param_shapes(ttfm.TransformerConfig(**MOE))


@pytest.mark.parametrize("name", ["fsdp", "fsdp_moe"])
def test_shards_at_construction_equal_jax(tmp_path_factory, port, name):
    """Each rank's shards after ``load_state`` of JAX's whole params, and
    ``convert.from_jax_lm_sharded``'s cut of them, bitwise the JAX
    trainer's shards on the same device."""
    jax_out = _jax(tmp_path_factory, name)
    keys = sorted(k[len("init/"):] for k in jax_out if k.startswith("init/"))
    cfg = tlm.LMTrainConfig(model=ttfm.TransformerConfig(**CASES[name][
        "model"]), dp=N, fsdp=True)
    dims = {k: tlm.fsdp_dim(s) for k, s in tlm.param_specs(cfg).items()}
    tree = convert.to_jax_params({k: torch.from_numpy(jax_out[f"init/{k}"])
                                  for k in keys})
    for r in range(N):
        conv = convert.from_jax_lm_sharded(tree, dims, r, N, device="cpu")
        for k in keys:
            got = port[f"rank{r}:{name}/shard0/{k}"]
            want = jax_out[f"shard0/rank{r}/{k}"]
            assert got.shape == want.shape, (k, r, got.shape, want.shape)
            assert np.array_equal(got, want), (k, r)
            assert np.array_equal(conv[k].numpy(), want), (k, r)
    # a ZeRO-3 shard is a quarter of its leaf
    assert port[f"rank0:{name}/shard0/embed"].shape == (64, 64)


@pytest.mark.parametrize("name", CASES)
def test_losses_equal_jax_on_every_rank(tmp_path_factory, port, name):
    jax_out = _jax(tmp_path_factory, name)
    tol = QUANT_LOSS_TOL if name in QUANTIZED else LOSS_TOL
    for r in range(N):
        np.testing.assert_allclose(port[f"rank{r}:{name}/losses"],
                                   jax_out["losses"], **tol)


@pytest.mark.parametrize("name", CASES)
def test_params_equal_jax_and_across_ranks(tmp_path_factory, port, name):
    jax_out = _jax(tmp_path_factory, name)
    keys = sorted(k[len("p/"):] for k in jax_out if k.startswith("p/"))
    assert keys
    for k in keys:
        got, want = port[f"rank0:{name}/p/{k}"], jax_out[f"p/{k}"]
        assert_params_in_band(got, want, k, quantized=name in QUANTIZED)
        for r in range(1, N):
            assert np.array_equal(port[f"rank{r}:{name}/p/{k}"], got), (k, r)


@pytest.mark.parametrize("name", ["fsdp", "fsdp_moe"])
def test_adam_moments_are_shards_of_jax(tmp_path_factory, port, name):
    """Each rank's Adam moments are its shards of JAX's: the moments of
    rank r concatenated over the ranks along the ZeRO-3 dim are the whole
    moments, within the params' band."""
    jax_out = _jax(tmp_path_factory, name)
    cfg = tlm.LMTrainConfig(model=ttfm.TransformerConfig(**CASES[name][
        "model"]), dp=N, fsdp=True)
    dims = {k: tlm.fsdp_dim(s) for k, s in tlm.param_specs(cfg).items()}
    for m in ("mu", "nu"):
        ranks = [{k.split(f"/{m}/", 1)[1]: v for k, v in port.items()
                  if k.startswith(f"rank{r}:{name}/{m}/")} for r in range(N)]
        whole = _flat_names(convert.to_jax_lm_gathered(ranks, dims))
        assert sorted(whole) == sorted(dims)
        for k, got in whole.items():
            want = jax_out[f"{m}/{k}"]
            if m == "mu":
                assert_params_in_band(got, want, f"{m}/{k}")
            else:  # squares: twice the gradient's relative noise
                np.testing.assert_allclose(got, want, rtol=2e-4,
                                           atol=1e-12, err_msg=f"{m}/{k}")


@pytest.mark.parametrize("name", CASES)
def test_evaluate_equals_jax(tmp_path_factory, port, name):
    jax_out = _jax(tmp_path_factory, name)
    want = jax_out["eval"]
    tol = QUANT_LOSS_TOL if name in QUANTIZED else LOSS_TOL
    for r in range(N):
        got = port[f"rank{r}:{name}/eval"]
        assert got[1] == want[1] == 8 * 63 - 2 * 15
        np.testing.assert_allclose(got[0], want[0], **tol)


def test_overlap_is_bitwise_the_non_overlapped_run(port):
    """Streaming the gathers per layer group and reduce-scattering each
    group's gradients right after its backward changes no value: losses,
    every rank's shards, params and moments bitwise the ``fsdp`` run's."""
    keys = [k for k in port if k.startswith("rank") and ":fsdp/" in k]
    assert keys
    for k in keys:
        other = k.replace(":fsdp/", ":fsdp_overlap/")
        assert np.array_equal(port[other], port[k]), k


def test_quantized_gather_codecs_equal_jax():
    """The int8 and int4 gathers' codec on leaves of one to three dims and
    an odd length, bitwise the JAX ``_q8_shard_gather`` /
    ``_q4_shard_gather`` arithmetic under ``jit`` (where XLA multiplies by
    the levels' reciprocal): the scales and levels, and the nibble packing
    round trip."""
    rng = np.random.default_rng(3)
    for shape, dim in (((64,), 0), ((16, 12), 1), ((5, 7, 3), 1),
                       ((8, 64), 0)):
        x = (rng.standard_normal(shape) * np.exp(rng.standard_normal(shape))
             ).astype(np.float32)
        axes = tuple(i for i in range(x.ndim) if i != dim)
        for bits in (8, 4):
            levels = 127.0 if bits == 8 else 7.0

            @jax.jit
            def codec(xj):
                sj = jax.numpy.maximum(jax.numpy.max(
                    jax.numpy.abs(xj), axis=axes, keepdims=True) / levels,
                    1e-30)
                return jax.numpy.clip(jax.numpy.round(xj / sj), -levels,
                                      levels).astype(jax.numpy.int8), sj

            qj, sj = codec(x)
            q, s = tlm.quantize_rows(torch.from_numpy(x), dim, bits)
            assert np.array_equal(s.numpy(), np.asarray(sj)), (shape, bits)
            assert np.array_equal(q.numpy(), np.asarray(qj)), (shape, bits)
            if bits == 4:
                packed = tlm.pack_rows(q, dim)
                assert torch.equal(tlm.unpack_rows(packed, dim,
                                                   shape[dim]), q)
