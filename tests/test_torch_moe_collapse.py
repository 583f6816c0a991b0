"""Is the MoE router's collapse the reference's?  Twenty f32 ``LMTrainer``
steps of a reduced MoE model in both packages, from the JAX trainer's
initial params on shared batches, compared step by step.

At LM-base with 8 experts the port's router drops about half of the
(token, choice) pairs after 20 bf16 steps (chip_smoke.py phase 20 (b)).
This test asks whether the JAX trainer's router goes the same way on the
same data: the model is LM-base cut to d_model 128 and 4 layers (layers 1
and 3 MoE, 8 experts, top-1, capacity factor 2, lm_cli's optimizer
defaults), 4 x 128 tokens a step from the port's synthetic corpus.

After every step both trainers' params run one forward over a fixed probe
batch (the first one): the summed aux of each package's own ``apply``, and
the share of tokens each MoE layer drops, from the layer's input and
router as each package's forward gives them (``_drop_share``, the top-1
capacity rule both ``moe_apply`` implement; the port's own ``stats`` are
held to it).  The port's losses are held to JAX's at the trainer band
(rtol 1e-5), the aux at rtol 1e-4 and the drop shares at one token in a
layer's 512, and the params after the 20 steps within the trainer bands
of tests/test_torch_moe_lm.py.  ``slow``: the two trainers' 20 steps and
the 42 probe forwards take about 40 s on the CPU.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import lm as jlm
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import lm as tlm
from distributed_pytorch_tpu_torch.data import lm_corpus as tcorpus
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from distributed_pytorch_tpu_torch.ops import moe as tmoe

SHAPE = dict(vocab_size=256, d_model=128, n_layers=4, n_heads=2,
             head_dim=64, d_ff=512, n_experts=8)
B, S, STEPS = 4, 128, 20
LOSS_TOL = dict(rtol=1e-5)
AUX_TOL = dict(rtol=1e-4)
DROP_TOL = 1.0 / (B * S)  # one token of a layer's routing group
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_FAR_SHARE = 1e-3
PARAM_TOL_ALL = dict(rtol=1e-4, atol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches():
    """STEPS batches of (B, S) next-byte windows of the synthetic corpus."""
    corpus = np.frombuffer(tcorpus.synthetic_corpus(200_000, seed=11),
                           dtype=np.uint8).astype(np.int32)
    starts = np.random.default_rng(20).integers(
        0, len(corpus) - S - 1, (STEPS, B))
    tokens = np.stack([[corpus[s:s + S] for s in row] for row in starts])
    targets = np.stack([[corpus[s + 1:s + S + 1] for s in row]
                        for row in starts])
    return tokens, targets


def _drop_share(x: np.ndarray, router: np.ndarray, n_experts: int,
                capacity_factor: float) -> float:
    """The share of a routing group's tokens a top-1 MoE layer drops:
    each token goes to its best expert (the lower index on a tie), and an
    expert keeps the first ``ceil(T cf / E)`` tokens in order."""
    t = x.shape[0]
    cap = min(max(1, math.ceil(t * capacity_factor / n_experts)), t)
    best = np.argmax(x.astype(np.float64) @ router.astype(np.float64),
                     axis=-1)
    counts = np.bincount(best, minlength=n_experts)
    return float(np.maximum(counts - cap, 0).sum()) / t


def _jax_probe(params, tokens, cfg):
    """The JAX package's aux and per-layer drop shares on ``tokens``."""
    seen = []
    real = jtfm.moe_ops.moe_apply

    def recording(p, x, **kw):
        jax.debug.callback(lambda a, r: seen.append(
            (np.asarray(a), np.asarray(r))), x, p["router"])
        return real(p, x, **kw)

    jtfm.moe_ops.moe_apply = recording
    try:
        _, aux = jtfm.apply(params, jnp.asarray(tokens), cfg=cfg,
                            attn_impl="reference", return_aux=True)
        jax.effects_barrier()
    finally:
        jtfm.moe_ops.moe_apply = real
    return float(aux), [_drop_share(x, r, cfg.n_experts, cfg.capacity_factor)
                        for x, r in seen]


def _port_probe(params, tokens, cfg):
    """The port's aux and per-layer drop shares on ``tokens`` (and its
    ``moe_apply`` stats' shares)."""
    seen, stats = [], []
    real = tmoe.moe_apply

    def recording(p, x, **kw):
        st = {}
        out = real(p, x, stats=st, **kw)
        seen.append((x.detach().numpy(), p["router"].detach().numpy()))
        stats.append(1.0 - float(st["kept"]) / float(st["routed"]))
        return out

    tmoe.moe_apply = recording
    try:
        with torch.no_grad():
            _, aux = ttfm.apply({n: p.detach() for n, p in params.items()},
                                torch.from_numpy(tokens).long(), cfg=cfg,
                                attn_impl="reference", return_aux=True)
    finally:
        tmoe.moe_apply = real
    return float(aux), [_drop_share(x, r, cfg.n_experts, cfg.capacity_factor)
                        for x, r in seen], stats


@pytest.mark.slow
def test_moe_router_collapse_is_the_references():
    tokens, targets = _batches()
    jcfg = jlm.LMTrainConfig(model=jtfm.TransformerConfig(**SHAPE),
                             compute_dtype=None)
    tcfg = tlm.LMTrainConfig(model=ttfm.TransformerConfig(**SHAPE),
                             compute_dtype=None)
    jtr = jlm.LMTrainer(jcfg)
    ttr = tlm.LMTrainer(tcfg, device="cpu", attn_impl="reference")
    ttr.load_state(convert.from_jax_params(
        jax.tree.map(np.asarray, jtr.params), device="cpu"))
    rows = []
    for step in range(STEPS + 1):
        if step:
            jl = float(jtr.train_step(tokens[step - 1], targets[step - 1]))
            tl = float(ttr.train_step(tokens[step - 1], targets[step - 1]))
        else:
            jl = tl = math.nan
        j_aux, j_drop = _jax_probe(jtr.params, tokens[0], jcfg.model)
        t_aux, t_drop, t_stats = _port_probe(ttr.params, tokens[0],
                                             tcfg.model)
        rows.append(dict(step=step, jax_loss=jl, port_loss=tl,
                         jax_aux=j_aux, port_aux=t_aux, jax_drop=j_drop,
                         port_drop=t_drop))
        print("MOE_STEP " + json.dumps(rows[-1]))
        np.testing.assert_allclose(t_stats, t_drop, atol=1e-12)
        assert len(j_drop) == len(t_drop) == 2
        if step:
            np.testing.assert_allclose(tl, jl, err_msg=f"step {step}",
                                       **LOSS_TOL)
        np.testing.assert_allclose(t_aux, j_aux, err_msg=f"step {step}",
                                   **AUX_TOL)
        np.testing.assert_allclose(t_drop, j_drop, err_msg=f"step {step}",
                                   atol=DROP_TOL)
    want = convert.from_jax_params(jax.tree.map(np.asarray, jtr.params),
                                   device="cpu")
    for n, p in ttr.params.items():
        got, w = p.detach().numpy(), want[n].numpy()
        np.testing.assert_allclose(got, w, err_msg=n, **PARAM_TOL_ALL)
        far = ~np.isclose(got, w, **PARAM_TOL)
        assert far.mean() <= PARAM_FAR_SHARE, (n, int(far.sum()))
