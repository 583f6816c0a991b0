#!/usr/bin/env python3
"""Train LM-base 30 steps through lm_cli --matmul-dtype int8 (chip_smoke.py's
phase 16 run) with the port of one source tree, for comparing two trees on
one card.  Run from the repository root:

    python3 scripts/int8_step_ab.py [--tree DIR] [--bf16]

``--tree`` names a checkout (a git archive unpacked into a git-ignored
directory): its package and its own chip_smoke.py are imported, and its
kernels build under it.  Without it, this checkout.  ``--bf16`` runs the
plain bf16 step instead (phase 8).  Prints the tree's training_run result
(ms/step, device ms and operations a step from torch.profiler, idle share,
launches, the top kernels) as one JSON line; to compare trees, run them in
turns in one call (A B B A).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("int8_step_ab: no CUDA device available", file=sys.stderr)
        return 2
    from distributed_pytorch_tpu_torch import lm_cli
    from distributed_pytorch_tpu_torch.ops import attention as attn
    from distributed_pytorch_tpu_torch.ops import quantized as qz
    if not str(Path(qz.__file__).resolve()).startswith(str(tree)):
        print(f"int8_step_ab: imported {qz.__file__}, not {tree}'s",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    facts = cs.card_facts(torch)
    port = {"attn": attn, "lm_cli": lm_cli, "qz": qz}
    extra = () if args.bf16 else ("--matmul-dtype", "int8")
    label = f"{tree.name} {'bf16' if args.bf16 else 'int8'}"
    res = cs.training_run(torch, port, extra=extra, label=label)
    res = {k: res[k] for k in res if k != "losses_every_10"}
    print("int8_step_ab: " + json.dumps({"tree": str(tree), "card":
                                         facts["smi"], **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
