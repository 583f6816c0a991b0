#!/usr/bin/env python3
"""The port's MoE and LM data-parallel paths on one CUDA GPU: chip_smoke.py's
phase 20 without the rest, for work on ops/moe.py, lm.py and lm_cli.py.  Run
from the repository root:

    python3 scripts/moe_probe.py

It builds the flash and decode kernels (the MoE paths launch K2-K4 and K6 /
K8), then runs chip_smoke.moe_phase at LM-base with ``--n-experts 8``: the
layer against its one-hot form at T = 8192 and its bf16 timings, a 2-layer
MoE train step through flash against reference attention, the MoE batcher
against ``generate``, 20 bf16 training steps, phase 5's serving load dense
and paged, and ``lm_cli --rendezvous env --dp 1`` under ``launch.py``
against the run with no process group (~4 min of command).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("moe_probe: no CUDA device available", file=sys.stderr)
        return 2
    from distributed_pytorch_tpu_torch import lm, lm_cli, serve
    from distributed_pytorch_tpu_torch import generate as gen
    from distributed_pytorch_tpu_torch.data import lm_corpus
    from distributed_pytorch_tpu_torch.models import transformer as tfm
    from distributed_pytorch_tpu_torch.ops import _build, moe
    from distributed_pytorch_tpu_torch.ops import attention as attn
    from distributed_pytorch_tpu_torch.ops import quantized as qz
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    facts = cs.card_facts(torch)
    print(f"{facts['smi']}; torch {torch.__version__}")
    libs = ("decode_attention", "flash_attention", "int8_matmul")
    _build.build_all(libs)
    for lib in libs:
        _build.load_library(lib)
    port = {"tfm": tfm, "gen": gen, "serve": serve, "attn": attn, "lm": lm,
            "lm_cli": lm_cli, "dev": "cuda", "cfg": tfm.PRESETS["LM-base"],
            "qz": qz, "corpus": lm_corpus, "moe": moe}
    t0 = time.perf_counter()
    cs.moe_phase(torch, port, facts)
    print(f"phase 20 took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
