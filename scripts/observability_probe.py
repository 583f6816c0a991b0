#!/usr/bin/env python3
"""The port's observability path on one CUDA GPU: chip_smoke.py's phase 23
without the rest, for work on utils/telemetry.py, utils/monitor.py,
utils/tracing.py and the trainers' emission.  Run from the repository
root:

    python3 scripts/observability_probe.py [--ops]

It builds ``csrc/flash_attention.cu`` and ``csrc/int8_matmul.cu``, trains
LM-base 16 steps through lm_cli (chip_smoke.training_run: phase 8's device
operations a step, the baseline of phase 23 (c)), then runs
chip_smoke.observability_phase: lm_cli with --telemetry-dir and
--profile-dir, train_steps against train_step calls, telemetry off / on
windows, record_memory and evaluate_run.  With ``--ops`` it instead
profiles 5 LM-base steps through lm_cli (logging every 100 and every 10
steps) and called directly on an LMTrainer (fresh and after 10 steps), and
prints the device operations of each window by kernel name where they
differ.  With ``--loss N`` it first profiles 3 N windows of 5 LM-base
steps, closed three ways in turn (``record_loss``), and prints where each
window lost device records.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def _by_name(prof) -> dict:
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0) + e.count
    return out


def ops_by_path(torch, port) -> None:
    """Device operations of 5 steps, by kernel name, on each path."""
    from torch.profiler import ProfilerActivity, profile
    lm, cli = port["lm"], port["lm_cli"]
    res = {}
    for log_every in (100, 10):
        prof = profile(activities=[ProfilerActivity.CUDA])

        def on_step(step, tr, loss, prof=prof):
            if step in (10, 15):
                torch.cuda.synchronize()
                (prof.start if step == 10 else prof.stop)()
        cli.run(["--preset", "LM-base", "--steps", "15", "--batch-size",
                 "8", "--seq-len", "1024", "--compute-dtype", "bfloat16",
                 "--log-every", str(log_every), "--device", "cuda"],
                on_step=on_step)
        res[f"lm_cli_log_every_{log_every}"] = _by_name(prof)
    tr = lm.LMTrainer(lm.LMTrainConfig(model=cs.lm_base_bytes(port),
                                       compute_dtype="bfloat16"))
    batches = cs._obs_batches(port, 15)
    p0, o0 = cs._obs_state(tr)
    for tag, warm in (("direct_fresh", 0), ("direct_after_10", 10)):
        tr.load_state(p0, o0)
        for bt in batches[:warm]:
            tr.train_step(*bt)
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        for bt in batches[warm:warm + 5]:
            tr.train_step(*bt)
        torch.cuda.synchronize()
        prof.stop()
        res[tag] = _by_name(prof)
    print("totals " + json.dumps({k: sum(v.values())
                                  for k, v in res.items()}))
    for key in sorted(set().union(*res.values())):
        row = [res[t].get(key, 0) for t in res]
        if len(set(row)) > 1:
            print(f"differs {row} {key[:120]}")


def _common_ends(a: list, b: list) -> tuple:
    """The lengths of a's and b's common prefix and (after it) suffix."""
    pre = 0
    while pre < min(len(a), len(b)) and a[pre] == b[pre]:
        pre += 1
    suf = 0
    while suf < min(len(a), len(b)) - pre and a[-1 - suf] == b[-1 - suf]:
        suf += 1
    return pre, suf


def record_loss(torch, port, n: int) -> None:
    """Where the profiler loses device records.  3 n windows of 5 direct
    LM-base train_step calls from one state, each opened by
    tracing.start_profile and closed, in turn, plainly (sync, stop), after
    a pad (sync, 256 step marks, sync, stop) or after a wait (sync, 0.2 s
    on the host, stop).  Each window's device records in time order, the
    marks left out, against the fullest window's: how many are missing,
    and the run that holds them (after the common prefix, before the
    common suffix)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    lm = port["lm"]
    tr = lm.LMTrainer(lm.LMTrainConfig(model=cs.lm_base_bytes(port),
                                       compute_dtype="bfloat16"))
    batches = cs._obs_batches(port, 5)
    p0, o0 = cs._obs_state(tr)
    runs = []
    for i in range(3 * n):
        close = ("plain", "pad", "wait")[i % 3]
        tr.load_state(p0, o0)
        torch.cuda.synchronize()
        prof = port["tracing"].start_profile([ProfilerActivity.CUDA])
        for bt in batches:
            tr.train_step(*bt)
        torch.cuda.synchronize()
        if close == "pad":
            for _ in range(256):
                cs.mark_step(torch)
            torch.cuda.synchronize()
        elif close == "wait":
            time.sleep(0.2)
        prof.stop()
        names = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        runs.append((close, [x for x in names if cs.STEP_MARK not in x],
                     len(names)))
    ref = max((r[1] for r in runs), key=len)
    for close, names, n_all in runs:
        pre, suf = _common_ends(names, ref)
        print("loss " + json.dumps({
            "close": close, "records": len(names), "of": len(ref),
            "missing": len(ref) - len(names), "marks": n_all - len(names),
            "run_from": pre, "run_to": len(ref) - suf,
            "one_run": pre + suf == len(names)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", action="store_true",
                    help="device operations by kernel name, lm_cli "
                         "against direct train_step calls")
    ap.add_argument("--loss", type=int, default=0, metavar="N",
                    help="first profile 3 N windows closed three ways and "
                         "print where records were lost")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("observability_probe: no CUDA device available",
              file=sys.stderr)
        return 2
    from distributed_pytorch_tpu_torch import lm, lm_cli
    from distributed_pytorch_tpu_torch.data import lm_corpus
    from distributed_pytorch_tpu_torch.models import transformer as tfm
    from distributed_pytorch_tpu_torch.ops import _build
    from distributed_pytorch_tpu_torch.ops import attention as attn
    from distributed_pytorch_tpu_torch.ops import quantized as qz
    from distributed_pytorch_tpu_torch.utils import (monitor, telemetry,
                                                      tracing)
    facts = cs.card_facts(torch)
    print(f"{facts['smi']}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(["flash_attention", "int8_matmul"])
    port = {"tfm": tfm, "attn": attn, "lm": lm, "lm_cli": lm_cli,
            "qz": qz, "corpus": lm_corpus, "telemetry": telemetry,
            "monitor": monitor, "tracing": tracing,
            "cfg": tfm.PRESETS["LM-base"]}
    if args.ops:
        ops_by_path(torch, port)
        return 0
    if args.loss:
        record_loss(torch, port, args.loss)
    base = cs.training_run(torch, port, steps=16)
    res = cs.observability_phase(torch, port, facts,
                                 base["device_ops_step"])
    print("phase 23 " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
