#!/usr/bin/env python3
"""One of chip_smoke.py's LM-base training phases alone on one CUDA GPU,
after phase 8's run it is held against.  Run from the repository root:

    python3 scripts/phase_probe.py 24   # checkpoints and faults
    python3 scripts/phase_probe.py 25   # elastic
    python3 scripts/phase_probe.py 26   # tensor and sequence parallel

It builds ``csrc/flash_attention.cu`` (and for 26 ``csrc/int8_matmul.cu``),
trains LM-base 30 steps through lm_cli (chip_smoke.training_run, phase 8:
the uninterrupted losses and the device operations a step; not for 26,
which holds nothing against it), then runs the phase:

  24  chip_smoke.checkpoint_phase: the crashed, restarted and resumed
      lm_cli run under launch.py, the training sentry, checkpoint
      corruption and the no-plan cost (utils/checkpoint.py,
      utils/faults.py, utils/sentry.py and the trainers' and CLIs'
      wiring);
  25  chip_smoke.elastic_phase: the SIGTERM drain of a standalone
      ``lm_cli --elastic``, its resume under ``launch.py --elastic`` and
      SyncRelaxHook's rebuilds of a VGG-11 window (launch.py's elastic
      agent, parallel/elastic.py, the trainers' ``rebuild``);
  26  chip_smoke.tp_sp_phase: ring attention through the loopback at a
      tp = 2 rank's attention shape (K2-K4, parallel/context.py) and K5
      at the tp shard shapes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

PHASES = {24: "checkpoint_phase", 25: "elastic_phase", 26: "tp_sp_phase"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", type=int, choices=sorted(PHASES))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("phase_probe: no CUDA device available", file=sys.stderr)
        return 2
    from distributed_pytorch_tpu_torch import lm, lm_cli, train
    from distributed_pytorch_tpu_torch.data import cifar10, lm_corpus
    from distributed_pytorch_tpu_torch.models import transformer as tfm
    from distributed_pytorch_tpu_torch.models import vgg
    from distributed_pytorch_tpu_torch.ops import _build
    from distributed_pytorch_tpu_torch.ops import attention as attn
    from distributed_pytorch_tpu_torch.ops import quantized as qz
    from distributed_pytorch_tpu_torch.parallel import context as pctx
    from distributed_pytorch_tpu_torch.utils import (monitor, telemetry,
                                                      tracing)
    facts = cs.card_facts(torch)
    print(f"{facts['smi']}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    _build.build_all(["flash_attention", "int8_matmul"] if args.phase == 26
                     else ["flash_attention"])
    port = {"tfm": tfm, "attn": attn, "lm": lm, "lm_cli": lm_cli,
            "qz": qz, "corpus": lm_corpus, "telemetry": telemetry,
            "monitor": monitor, "tracing": tracing, "train": train,
            "vgg": vgg, "cifar10": cifar10, "ctx": pctx,
            "cfg": tfm.PRESETS["LM-base"]}
    if args.phase == 26:
        res = cs.tp_sp_phase(torch, port, facts)
    else:
        base = cs.training_run(torch, port)
        res = getattr(cs, PHASES[args.phase])(torch, port, facts, base)
    print(f"phase {args.phase} " + json.dumps(res))
    print(f"probe took {time.perf_counter() - t0:.1f} s")
    print(f"processes the phase left, stopped: {len(cs.stop_strays())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
