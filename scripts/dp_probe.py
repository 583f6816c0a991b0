#!/usr/bin/env python3
"""The port's data-parallel VGG path on one CUDA GPU: chip_smoke.py's
phase 19 without the rest (and with ``--cli``, phase 14's bf16 epoch at the
CLI's default ``ddp`` first), for work on parallel/ and train.py.  Run from
the repository root:

    python3 scripts/dp_probe.py [--cli]

It builds ``csrc/fused_bn.cu`` (phase 19 (f) launches K1a/K1b), then runs
chip_smoke.dp_phase: every strategy on one saved set of VGG-11 gradients,
20 steps of each against the spread of two plain runs, the collectives one
step issues, ddp against none in A B B A windows, and ddp with
``fused_bn=True``.  A one-rank NCCL group stands in for the gang: the
machine has one card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cli", action="store_true",
                    help="run phase 14's bf16 cli epoch at ddp first")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dp_probe: no CUDA device available", file=sys.stderr)
        return 2
    from distributed_pytorch_tpu_torch import cli, train
    from distributed_pytorch_tpu_torch.data import cifar10
    from distributed_pytorch_tpu_torch.models import vgg
    from distributed_pytorch_tpu_torch.ops import _build, fused_bn, nn
    from distributed_pytorch_tpu_torch.parallel import init as pinit
    from distributed_pytorch_tpu_torch.parallel import mesh as pmesh
    from distributed_pytorch_tpu_torch.parallel import strategies
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    facts = cs.card_facts(torch)
    print(f"{facts['smi']}; torch {torch.__version__}")
    _build.build_all(("fused_bn",))
    _build.load_library("fused_bn")
    port = {"train": train, "cli": cli, "vgg": vgg, "fused_bn": fused_bn,
            "cifar10": cifar10, "nn": nn, "strategies": strategies,
            "mesh": pmesh, "parallel_init": pinit}
    if args.cli:
        t0 = time.perf_counter()
        cs.vgg_cli_run(torch, port, ["--compute-dtype", "bfloat16"],
                       "VGG-11 bfloat16 cli epoch (ddp)", strategy=None)
        print(f"phase 14 bf16 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cs.dp_phase(torch, port, facts)
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
