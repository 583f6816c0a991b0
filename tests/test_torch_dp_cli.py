"""The port's launcher (distributed_pytorch_tpu_torch/launch.py, the
non-elastic gang), its rank flags through cli.py, its ``--telemetry-dir``
(the gang's events and every rank's stream in one run directory, a
``worker_fault`` postmortem), and ``evaluate_sharded``, on the CPU.  No
JAX oracle: the launcher's contract is the JAX package's
tests/test_launch.py (the torchrun env convention, teardown of a failed
gang, ``--max-restarts``, generation-coordinated restarts across nodes),
and the command-line runs hold the ranks against each other.  Every TCP
port is picked free at run time.
"""

import json
import os
import pickle
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distributed_pytorch_tpu_torch import eval as teval
from distributed_pytorch_tpu_torch import launch as tlaunch
from distributed_pytorch_tpu_torch.data import cifar10 as tcifar
from distributed_pytorch_tpu_torch.data import pipeline as tpipe
from distributed_pytorch_tpu_torch.models import vgg as tvgg
from distributed_pytorch_tpu_torch.utils import monitor as tmon
from distributed_pytorch_tpu_torch.utils import telemetry as ttel
from workers.torch_dp_worker import run_gang, shared_result

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*a):
    pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- launch.py -------------------------------------------------------------

def test_worker_specs_env_contract():
    agent = tlaunch.LocalAgent(["x.py"], nnodes=4, node_rank=2,
                               nproc_per_node=2, master_addr="10.0.0.1",
                               master_port=6585, log=_quiet)
    specs = agent.specs()
    assert [s.rank for s in specs] == [4, 5]
    env = specs[1].env()
    assert (env["MASTER_ADDR"], env["MASTER_PORT"], env["WORLD_SIZE"],
            env["LOCAL_WORLD_SIZE"], env["RANK"], env["LOCAL_RANK"],
            env["NODE_RANK"]) == ("10.0.0.1", "6585", "8", "2", "5", "1",
                                  "2")


def test_gang_success_and_env_propagation(tmp_path):
    prog = ("import os, json, pathlib; pathlib.Path(r'" + str(tmp_path)
            + "', os.environ['RANK']).write_text(json.dumps({k: os.environ"
            "[k] for k in ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', "
            "'LOCAL_WORLD_SIZE', 'NODE_RANK', 'RESTART_ATTEMPT', "
            "'MASTER_ADDR', 'MASTER_PORT')}))")
    agent = tlaunch.LocalAgent(["-c", prog], nproc_per_node=3,
                               master_port=7001, log=_quiet)
    result = agent.run()
    assert result.returncode == 0 and result.per_rank == {0: 0, 1: 0, 2: 0}
    import json
    for r in range(3):
        env = json.loads((tmp_path / str(r)).read_text())
        assert env == {"RANK": str(r), "LOCAL_RANK": str(r),
                       "WORLD_SIZE": "3", "LOCAL_WORLD_SIZE": "3",
                       "NODE_RANK": "0", "RESTART_ATTEMPT": "0",
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "7001"}


def test_failure_detection_tears_down_gang():
    prog = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1': sys.exit(3)\n"
            "time.sleep(60)\n")
    agent = tlaunch.LocalAgent(["-c", prog], nproc_per_node=3,
                               monitor_interval_s=0.05, log=_quiet)
    t0 = time.monotonic()
    result = agent.run()
    assert time.monotonic() - t0 < 30
    assert (result.returncode, result.failed_rank) == (3, 1)
    assert result.per_rank[0] != 0 and result.per_rank[2] != 0
    assert result.drain["exited"] + result.drain["killed"] == 2


@pytest.mark.parametrize("fails,budget,want_rc,want_restarts", [
    (1, 2, 0, 1), (5, 1, 7, 1)])
def test_max_restarts(tmp_path, fails, budget, want_rc, want_restarts):
    """The gang restarts (RESTART_ATTEMPT counts the generations) until it
    succeeds or the budget is spent, through main() and its flags."""
    prog = ("import os, sys\n"
            f"sys.exit(7 if int(os.environ['RESTART_ATTEMPT']) < {fails} "
            "else 0)\n")
    rc = tlaunch.main(["--nproc-per-node", "1", "--max-restarts",
                       str(budget), "--monitor-interval", "0.05", "--",
                       "-c", prog])
    assert rc == want_rc
    agent = tlaunch.LocalAgent(["-c", prog], max_restarts=budget,
                               monitor_interval_s=0.05, log=_quiet)
    result = agent.run()
    assert (result.returncode, result.restarts_used) == (want_rc,
                                                         want_restarts)


def test_parser_takes_torchrun_flags():
    from distributed_pytorch_tpu import launch as jlaunch
    args = tlaunch.build_parser().parse_args(
        ["--nproc_per_node=2", "--nnodes=4", "--node_rank=1",
         "--master_addr=172.18.0.2", "--master_port=6585",
         "--max-restarts", "3", "--monitor-interval", "0.5",
         "--agent-port", "7000", "--", "-m",
         "distributed_pytorch_tpu_torch.cli", "--rendezvous", "env"])
    assert (args.nproc_per_node, args.nnodes, args.node_rank,
            args.master_addr, args.master_port, args.max_restarts,
            args.monitor_interval, args.agent_port) == (
        2, 4, 1, "172.18.0.2", 6585, 3, 0.5, 7000)
    assert args.cmd[:3] == ["--", "-m", "distributed_pytorch_tpu_torch.cli"]
    # every flag of the JAX launcher's parser, under the same spellings
    want = {s for a in jlaunch.build_parser()._actions
            for s in a.option_strings}
    got = {s for a in tlaunch.build_parser()._actions
           for s in a.option_strings}
    assert got == want


@pytest.mark.parametrize("argv", [["--elastic"], ["--min-nodes", "2"],
                                  ["--telemetry-dir", "t"]])
def test_elastic_and_telemetry_flags_name_slice_5c(argv, tmp_path,
                                                   monkeypatch):
    """The elastic flags are ported (slice 5c-iii): ``--elastic`` runs a
    one-worker elastic gang, whose worker gets the heartbeat directory and
    the bounds, and ``--min-nodes`` without it is the JAX launcher's
    usage error; ``--telemetry-dir`` is ported (slice 5c-i): the gang
    runs, the agent's file (rank -1) holds its start, exit and end events,
    and the workers get the directory in ``TELEMETRY_DIR`` while the
    agent's own environment is left alone."""
    if argv[0] == "--min-nodes":
        with pytest.raises(SystemExit) as e:
            tlaunch.main(argv + ["--", "-c", "pass"])
        assert e.value.code == 2
        return
    if argv[0] == "--elastic":
        monkeypatch.chdir(tmp_path)
        prog = ("import os, pathlib; pathlib.Path('env').write_text("
                "' '.join(os.environ[k] for k in ('ELASTIC_MIN_NODES', "
                "'ELASTIC_MAX_NODES', 'WORLD_SIZE')) + ' ' + str(os.path."
                "isdir(os.environ['ELASTIC_DIR'])))")
        assert tlaunch.main(argv + ["--", "-c", prog]) == 0
        assert (tmp_path / "env").read_text() == "1 1 1 True"
        return
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(ttel.TELEMETRY_DIR_ENV, raising=False)
    prog = ("import os, pathlib; pathlib.Path(os.environ['RANK']).write_text("
            "os.environ['TELEMETRY_DIR'])")
    assert tlaunch.main(argv + ["--nproc-per-node", "2", "--", "-c",
                                prog]) == 0
    assert ttel.TELEMETRY_DIR_ENV not in os.environ
    assert ttel.active() is None
    assert [(tmp_path / r).read_text() for r in "01"] == ["t", "t"]
    s = ttel.run_summary(str(tmp_path / "t"))
    assert s["ranks"] == [-1]
    ev = s["events"]
    assert ev["rank-1/gang/worker_start"]["count"] == 2
    assert ev["rank-1/gang/gang_done"]["count"] == 1
    assert "rank-1/gang/worker_exit" not in ev
    assert tmon.find_postmortems(str(tmp_path / "t")) == []


def test_entry_points_take_telemetry_and_profile_dirs():
    """cli, lm_cli and launch take ``--telemetry-dir`` (default None: the
    CLIs then read the launcher's TELEMETRY_DIR), the two CLIs
    ``--profile-dir``, under the JAX package's spellings."""
    from distributed_pytorch_tpu_torch import cli, lm_cli
    for mod in (cli, lm_cli, tlaunch):
        tail = ["--", "-c", "pass"] if mod is tlaunch else []
        args = mod.build_parser().parse_args(["--telemetry-dir", "/tmp/t"]
                                             + tail)
        assert args.telemetry_dir == "/tmp/t"
        assert mod.build_parser().parse_args(tail).telemetry_dir is None
        if mod is not tlaunch:
            assert mod.build_parser().parse_args(
                ["--profile-dir", "p"]).profile_dir == "p"


def test_lm_cli_writes_a_trace_and_a_jsonl(tmp_path):
    """A tiny ``lm_cli`` run with both flags: one torch.profiler Chrome
    trace (steps 2-3 of 3, closed by the short run) and rank 0's JSONL
    file with a step span and three gauges a step."""
    from distributed_pytorch_tpu_torch import lm_cli
    run, prof = tmp_path / "run", tmp_path / "prof"
    lm_cli.run(["--device", "cpu", "--d-model", "32", "--n-layers", "1",
                "--n-heads", "1", "--head-dim", "32", "--seq-len", "32",
                "--batch-size", "2", "--steps", "3", "--telemetry-dir",
                str(run), "--profile-dir", str(prof)])
    (trace,) = os.listdir(prof)
    assert trace.endswith(".pt.trace.json")
    with open(prof / trace) as f:
        assert json.load(f)["traceEvents"]
    (name,) = os.listdir(run)
    assert name.startswith("events_rank0_gen0_") and name.endswith(".jsonl")
    s = ttel.run_summary(str(run))
    assert s["spans"]["rank0/train/lm_train_step"]["count"] == 3
    assert s["gauges"]["rank0/train/param_norm"]["count"] == 3
    assert ttel.active() is None


@pytest.mark.parametrize("code", [3, 77])
def test_failed_worker_leaves_a_worker_fault_bundle(tmp_path, code):
    """A worker that exits non-zero (a failure, or an injected fault's
    code 77) tears the gang down and leaves one ``worker_fault`` bundle
    in the run directory: strict JSON, the failed rank and its code, the
    agent's view of the gang, the agent's events in its ring and its log
    lines in the tail; the agent's stream records the exit."""
    run = str(tmp_path / "run")
    prog = ("import os, sys, time\n"
            f"if os.environ['RANK'] == '1': sys.exit({code})\n"
            "time.sleep(60)\n")
    assert tlaunch.main(["--telemetry-dir", run, "--nproc-per-node", "2",
                         "--monitor-interval", "0.05", "--", "-c",
                         prog]) == code
    (path,) = tmon.find_postmortems(run)
    b = tmon.load_postmortem(path)
    kind = "injected fault" if code == 77 else "failure"
    assert b["trigger"] == {"kind": "worker_fault", "rank": 1,
                            "code": code, "classified": kind}
    assert b["gang"]["world_size"] == 2 and b["gang"]["gen"] == 0
    assert b["gang"]["ranks"]["1"] == code
    assert [r["name"] for r in b["ring"]] == ["worker_start"] * 2 + [
        "worker_exit"]
    assert any("FAILED with exit code" in ln for ln in b["log_tail"])
    ev = ttel.run_summary(run)["events"]
    assert ev["rank-1/gang/worker_exit"]["count"] == 1
    assert ev["rank-1/slo/postmortem"]["count"] == 1


def test_coordinated_multinode_restart():
    """Node 1's worker fails in generation 0: both nodes tear down, meet
    at the generation-1 barrier and succeed together."""
    prog = ("import os, sys, time\n"
            "gen = int(os.environ['RESTART_ATTEMPT'])\n"
            "if gen == 0 and os.environ['NODE_RANK'] == '1': sys.exit(5)\n"
            "if gen == 0: time.sleep(60)\n"
            "sys.exit(0)\n")
    port = _free_port()
    results = {}

    def agent(node):
        results[node] = tlaunch.LocalAgent(
            ["-c", prog], nnodes=2, node_rank=node, master_port=port - 1,
            agent_port=port, max_restarts=2, monitor_interval_s=0.05,
            log=_quiet).run()

    threads = [threading.Thread(target=agent, args=(n,)) for n in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for node in (0, 1):
        assert (results[node].returncode, results[node].restarts_used) == \
            (0, 1), results


# -- the rank flags through cli.py -----------------------------------------

def _write_cifar(root, n_train: int, n_test: int) -> str:
    """A CIFAR-10 python-pickle directory of synthetic images."""
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)

    def dump(name, ds):
        data = ds.images.transpose(0, 3, 1, 2).reshape(len(ds), -1)
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": data, b"labels": ds.labels.tolist()}, f)

    train = tcifar._synthetic(n_train, seed=0)
    per = n_train // 5
    for i in range(5):
        dump(f"data_batch_{i + 1}", tcifar.Dataset(
            images=train.images[i * per:(i + 1) * per],
            labels=train.labels[i * per:(i + 1) * per]))
    dump("test_batch", tcifar._synthetic(n_test, seed=1))
    return root


CLI = ["-m", "distributed_pytorch_tpu_torch.cli", "--device", "cpu",
       "--model", "TINY", "--batch-size", "4", "--no-augment",
       "--debug-checks", "--lr", "0.02"]
# the ranks share the launcher's stdout, so their lines may interleave
REPORT = re.compile(r"Epoch: 1, Iteration: \d+-\d+, Average Loss: [0-9.]+|"
                    r"Test set[^\n]*?Accuracy: \d+/\d+ \(\d+%\)")


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")


def _reports(outs: list[str]) -> list[list[str]]:
    return [REPORT.findall(o) for o in outs]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two 2-rank epochs over 160 train / 16 test images (20 steps a rank
    at batch 4): through launch.py with --rendezvous env, and as two
    processes with --master-ip/--num-nodes/--rank; each rank's report
    lines."""
    def compute():
        data = _write_cifar(str(tmp_path_factory.mktemp("cifar")), 160, 16)
        run_dir = str(tmp_path_factory.mktemp("cli_telemetry"))
        port = _free_port()
        env_run = subprocess.run(
            [sys.executable, "-m", "distributed_pytorch_tpu_torch.launch",
             "--nproc-per-node", "2", "--master-port", str(port),
             "--telemetry-dir", run_dir, "--"]
            + CLI + ["--rendezvous", "env", "--data-dir", data,
                     "--shard-eval"],
            env=_env(), cwd=REPO, capture_output=True, text=True,
            timeout=240)
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable] + CLI + [
                "--master-ip", "127.0.0.1", "--num-nodes", "2", "--rank",
                str(r), "--port", str(port), "--data-dir", data],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = [p.communicate(timeout=240)[0] for p in procs]
        trace = ttel.merge_chrome_trace(run_dir)
        return {"env_rc": np.asarray(env_run.returncode),
                "env_out": np.asarray(env_run.stdout + env_run.stderr),
                "tel_summary": np.asarray(json.dumps(
                    ttel.run_summary(run_dir))),
                "tel_trace": np.asarray(json.dumps(trace)),
                "args_rc": np.asarray([p.returncode for p in procs]),
                "args_out0": np.asarray(outs[0]),
                "args_out1": np.asarray(outs[1])}
    return shared_result(tmp_path_factory, "torch_dp_cli_runs", compute)


def test_two_rank_cli_through_launch_and_env_rendezvous(cli_runs):
    out = str(cli_runs["env_out"])
    assert int(cli_runs["env_rc"]) == 0, out[-3000:]
    lines = REPORT.findall(out)
    # each rank printed the same averaged loss window and the same
    # sharded evaluation (the launcher interleaves their lines)
    losses = [x for x in lines if x.startswith("Epoch")]
    evals = [x for x in lines if x.startswith("Test set (sharded x2)")]
    assert len(losses) == 2 and losses[0] == losses[1], lines
    assert len(evals) == 2 and evals[0] == evals[1], lines
    assert out.count("replica-consistency checks passed") == 2


def test_two_rank_launch_telemetry_merges_agent_and_ranks(cli_runs):
    """The 2-rank launch above ran with --telemetry-dir: the merged trace
    has pids -1 (the agent), 0 and 1, each rank's 20 steps as
    ``train_steps`` spans with their gauges, and the agent's gang
    events; the merged trace is strict JSON."""
    s = json.loads(str(cli_runs["tel_summary"]))
    trace = json.loads(str(cli_runs["tel_trace"]))
    assert s["ranks"] == [-1, 0, 1]
    assert {e["pid"] for e in trace["traceEvents"]} == {-1, 0, 1}
    names = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert names == {-1: "agent", 0: "rank 0", 1: "rank 1"}
    for r in (0, 1):
        assert s["counters"][f"rank{r}/train/steps"] == 20
        assert s["spans"][f"rank{r}/train/train_steps"]["count"] == 20
        assert s["gauges"][f"rank{r}/train/loss"]["count"] == 20
        assert s["gauges"][f"rank{r}/train/window_loss"]["count"] == 1
        assert s["spans"][f"rank{r}/compile/train_step_build"]["count"] == 1
    assert s["events"]["rank-1/gang/worker_start"]["count"] == 2
    assert s["events"]["rank-1/gang/gang_done"]["count"] == 1
    # both ranks gauge the same rank-averaged losses
    assert s["gauges"]["rank0/train/loss"] == s["gauges"]["rank1/train/loss"]


def test_two_rank_cli_through_args_rendezvous(cli_runs):
    outs = [str(cli_runs["args_out0"]), str(cli_runs["args_out1"])]
    assert list(cli_runs["args_rc"]) == [0, 0], outs[0][-3000:]
    a, b = _reports(outs)
    assert a and a == b, (a, b)
    assert a[-1].startswith("Test set: Average loss")
    assert all("replica-consistency checks passed" in o for o in outs)
    assert all("rank=%d/2" % r in o for r, o in enumerate(outs))


# -- evaluate_sharded ------------------------------------------------------

@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return shared_result(tmp_path_factory, "torch_dp_eval", lambda: {
        f"rank{r}:{k}": v for r, out in enumerate(run_gang(
            "eval", {"n": np.asarray(36), "batch": np.asarray(16)},
            str(tmp_path_factory.mktemp("eval_gang"))))
        for k, v in out.items()})


@pytest.mark.parametrize("fold", [False, True])
def test_evaluate_sharded_equals_evaluate(sharded, fold):
    """36 images in batches of 16, 16, 4 over 4 ranks (the last padded):
    the loss of ``evaluate`` (the mean of per-batch means) and its
    accuracy, on every rank."""
    params, state = tvgg.init(3, "TINY", device="cpu")
    want = teval.evaluate(params, state,
                          tpipe.DataLoader(tcifar._synthetic(36, 3), 16),
                          model_name="TINY", fold_bn=fold, log=None,
                          device="cpu")
    for r in range(4):
        loss, acc = sharded[f"rank{r}:fold{int(fold)}"]
        np.testing.assert_allclose(loss, want[0], rtol=1e-6)
        assert acc == want[1]


def test_evaluate_sharded_refuses_a_batch_the_ranks_do_not_divide(sharded):
    for r in range(4):
        assert "must be divisible by the 4-device mesh" in \
            str(sharded[f"rank{r}:refused"])
