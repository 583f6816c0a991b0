"""The port's data-parallel LM trainer (distributed_pytorch_tpu_torch/lm.py
with ``dp``, and lm_cli.py's rank flags) against the JAX package's, on the
CPU.

The port's ``LMTrainer(dp=4)`` runs in a 4-rank Gloo gang (tests/workers/
torch_dp_worker.py, mode ``lm``); the JAX ``LMTrainer(dp=4)`` on the
4-device CPU mesh.  Both start from the JAX trainer's initial params
(convert.py) and take three float32 steps on one global batch of 8 x 64
tokens, rank r taking rows [2r, 2r + 2) as the JAX mesh shards them; a
quarter of rank 1's targets are ignored, so only the GLOBAL valid-token
count gives JAX's loss.  Cases: the dense model, the MoE model (4 experts,
layer 1; each rank's tokens are its own routing group, the aux averaged
over the ranks) and the MoE model with ``grad_accum=2`` (each rank's
interleaved microbatches are its shard of JAX's global interleaved split).
The dense head, no int8 (JAX's ``shard_map``'d step does not trace the
chunked head or int8 on this JAX version).

Held: every rank's losses to rtol 1e-5 of JAX's; its params after the
steps to rtol 1e-5 / atol 1e-6 for all but 0.1% of each tensor's entries
and every entry within rtol 1e-4 / atol 5e-4 (tests/test_torch_lm.py's
bound: Adam amplifies float32 summation-order noise on near-zero gradient
entries), the four ranks' params bitwise equal; ``evaluate`` on each
rank's rows equal to JAX's on the whole batch.  ``lm_cli --dp 4`` under
``launch.py`` (a dense model) trains on each rank's stride of the corpus
and logs the losses of one process training the same global batches.
"""

import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import lm as jlm
from distributed_pytorch_tpu.models import transformer as jtfm
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch import lm as tlm
from distributed_pytorch_tpu_torch.data import lm_corpus as tcorpus
from distributed_pytorch_tpu_torch.models import transformer as ttfm
from workers.torch_dp_worker import run_gang, shared_result

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
STEPS = 3
SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=1,
             head_dim=64, d_ff=128)
CASES = {
    "dense": dict(model=SHAPE),
    "moe": dict(model=dict(SHAPE, n_experts=4)),
    "moe_grad_accum2": dict(model=dict(SHAPE, n_experts=4),
                            cfg=dict(grad_accum=2)),
}
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_FAR_SHARE = 1e-3
PARAM_TOL_ALL = dict(rtol=1e-4, atol=5e-4)


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


def _jax_runs() -> dict:
    tokens, targets = _batch()
    out = {}
    for name, case in CASES.items():
        cfg = jlm.LMTrainConfig(model=jtfm.TransformerConfig(**case["model"]),
                                compute_dtype=None, dp=N,
                                **case.get("cfg", {}))
        tr = jlm.LMTrainer(cfg)
        init = convert.from_jax_params(jax.tree.map(np.asarray, tr.params),
                                       device="cpu")
        out.update({f"{name}/init/{k}": v.numpy() for k, v in init.items()})
        out[f"{name}/losses"] = np.asarray(
            [float(tr.train_step(tokens, targets)) for _ in range(STEPS)])
        final = convert.from_jax_params(jax.tree.map(np.asarray, tr.params),
                                        device="cpu")
        out.update({f"{name}/p/{k}": v.numpy() for k, v in final.items()})
        ev = tr.evaluate([(tokens, targets)])
        out[f"{name}/eval"] = np.asarray([ev["loss"], ev["tokens"]])
    return out


def _port_runs(tmp_path_factory, jax_out) -> dict:
    tokens, targets = _batch()
    out = {}
    for name, case in CASES.items():
        inputs = {"tokens": tokens, "targets": targets}
        prefix = f"{name}/init/"
        inputs.update({"p/" + k[len(prefix):]: v for k, v in jax_out.items()
                       if k.startswith(prefix)})
        case = dict(case, steps=STEPS)
        ranks = run_gang("lm", inputs,
                         str(tmp_path_factory.mktemp(f"lm_dp_{name}")),
                         world=N, cases={name: case})
        out.update({f"rank{r}:{k}": v for r, o in enumerate(ranks)
                    for k, v in o.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_out = shared_result(tmp_path_factory, "torch_lm_dp_jax", _jax_runs)
    port = shared_result(tmp_path_factory, "torch_lm_dp_port",
                         lambda: _port_runs(tmp_path_factory, jax_out))
    return jax_out, port


@pytest.mark.parametrize("name", CASES)
def test_losses_equal_jax_on_every_rank(runs, name):
    jax_out, port = runs
    for r in range(N):
        np.testing.assert_allclose(port[f"rank{r}:{name}/losses"],
                                   jax_out[f"{name}/losses"], **LOSS_TOL)


@pytest.mark.parametrize("name", CASES)
def test_params_equal_jax_and_across_ranks(runs, name):
    jax_out, port = runs
    keys = sorted(k for k in jax_out if k.startswith(f"{name}/p/"))
    assert keys
    for k in keys:
        want = jax_out[k]
        got = port[f"rank0:{k}"]
        np.testing.assert_allclose(got, want, err_msg=k, **PARAM_TOL_ALL)
        far = ~np.isclose(got, want, **PARAM_TOL)
        assert far.mean() <= PARAM_FAR_SHARE, (k, int(far.sum()))
        for r in range(1, N):
            np.testing.assert_array_equal(port[f"rank{r}:{k}"], got)


@pytest.mark.parametrize("name", CASES)
def test_evaluate_equals_jax(runs, name):
    jax_out, port = runs
    want = jax_out[f"{name}/eval"]
    for r in range(N):
        got = port[f"rank{r}:{name}/eval"]
        assert got[1] == want[1] == 8 * 63 - 2 * 15
        np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)


def test_dp_beyond_the_gang_names_the_launcher(runs):
    _, port = runs
    for r in range(N):
        msg = str(port[f"rank{r}:refused"])
        assert "launch --nproc-per-node 5" in msg, msg
    with pytest.raises(NotImplementedError, match="nproc-per-node 2"):
        tlm.LMTrainer(tlm.LMTrainConfig(dp=2), device="cpu")


# -- lm_cli --dp 4 under launch.py -----------------------------------------

CLI_MODEL = ["--d-model", "64", "--n-layers", "2", "--n-heads", "1",
             "--head-dim", "64", "--seq-len", "32",
             "--batch-size", "8", "--compute-dtype", "float32",
             "--steps", "3", "--log-every", "1", "--seed", "3"]
STEP_LINE = re.compile(r"step (\d+) \| loss ([0-9.]+)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``lm_cli --rendezvous env --dp 4`` through launch.py on a 40 KB
    corpus; and the same three global batches (each rank's loader rows,
    concatenated in rank order) through one f32 LMTrainer.  The model is
    dense: an MoE layer routes each rank's tokens as a group of its own,
    so one process over the whole batch is no oracle for it (the gang
    above holds MoE against JAX's dp=4 mesh instead)."""
    def compute():
        corpus = tmp_path_factory.mktemp("lm_corpus") / "corpus.txt"
        corpus.write_bytes(tcorpus.synthetic_corpus(40_000, seed=5))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        run = subprocess.run(
            [sys.executable, "-m", "distributed_pytorch_tpu_torch.launch",
             "--nproc-per-node", str(N), "--master-port", str(_free_port()),
             "--", "-m", "distributed_pytorch_tpu_torch.lm_cli",
             "--rendezvous", "env", "--dp", str(N), "--device", "cpu",
             "--corpus", str(corpus)] + CLI_MODEL,
            env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
        data = tcorpus.load_corpus(str(corpus))
        loaders = [tcorpus.LMDataLoader(data, 2, 32, num_replicas=N, rank=r,
                                        seed=3, shuffle_mode="permutation")
                   for r in range(N)]
        for ld in loaders:
            ld.set_epoch(0)
        model = ttfm.TransformerConfig(vocab_size=256, d_model=64,
                                       n_layers=2, n_heads=1, head_dim=64)
        tr = tlm.LMTrainer(tlm.LMTrainConfig(model=model, seed=3,
                                             compute_dtype=None),
                           device="cpu")
        want = []
        for batches in zip(*[iter(ld) for ld in loaders]):
            tokens = np.concatenate([b[0] for b in batches])
            targets = np.concatenate([b[1] for b in batches])
            want.append(float(tr.train_step(tokens, targets)))
            if len(want) == 3:
                break
        return {"rc": np.asarray(run.returncode),
                "out": np.asarray(run.stdout + run.stderr),
                "want": np.asarray(want)}
    return shared_result(tmp_path_factory, "torch_lm_dp_cli", compute)


def test_lm_cli_dp4_under_launch(cli_run):
    """Every rank trained (rendezvous lines of 4 ranks), rank 0 alone
    logged the three steps, and its losses are those of one process
    training on the four ranks' rows put together (rtol 1e-4: the log
    prints four decimals)."""
    out = str(cli_run["out"])
    assert int(cli_run["rc"]) == 0, out[-3000:]
    assert all(f"rank {r}/{N}: connected" in out for r in range(N)), out
    steps = STEP_LINE.findall(out)
    assert [int(s) for s, _ in steps] == [1, 2, 3], steps
    np.testing.assert_allclose([float(v) for _, v in steps],
                               cli_run["want"], rtol=1e-4)
    assert "| rank 0/4" in out and "| rank 1/4" not in out
