#!/usr/bin/env python3
"""The port's checkpoint and fault path on one CUDA GPU: chip_smoke.py's
phase 24 without the rest, for work on utils/checkpoint.py,
utils/faults.py, utils/sentry.py and the trainers' and CLIs' wiring.  Run
from the repository root:

    python3 scripts/checkpoint_probe.py

It builds ``csrc/flash_attention.cu``, trains LM-base 30 steps through
lm_cli (chip_smoke.training_run, phase 8: the uninterrupted losses and the
device operations a step that phase 24 is held against), then runs
chip_smoke.checkpoint_phase: the crashed, restarted and resumed lm_cli run
under launch.py, the training sentry, checkpoint corruption, and the
no-plan cost.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("checkpoint_probe: no CUDA device available", file=sys.stderr)
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
    t0 = time.perf_counter()
    _build.build_all(["flash_attention"])
    port = {"tfm": tfm, "attn": attn, "lm": lm, "lm_cli": lm_cli,
            "qz": qz, "corpus": lm_corpus, "telemetry": telemetry,
            "monitor": monitor, "tracing": tracing,
            "cfg": tfm.PRESETS["LM-base"]}
    base = cs.training_run(torch, port)
    res = cs.checkpoint_phase(torch, port, facts, base)
    print("phase 24 " + json.dumps(res))
    print(f"probe took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
