#!/usr/bin/env python3
"""Overlapped dispatch on against off at LM-base bf16 (chip_smoke.py's
phase 18 (b)) in full, for one card.  Run from the repository root:

    python3 scripts/serving_overlap_ab.py [--pairs N] [--decode-pairs N]

Builds the decode kernel, then runs ``chip_smoke.overlap_windows`` on
phase 5's load (16 requests of 64-480 prompt tokens, 64-256 new, 8 slots,
16 steps a block, in-block refill on): load windows alternated A B B A
``--pairs`` times, one profiled load window of each side (the load's
device time, idle share and device operations per emitted token, which
chip_smoke.py leaves out for time), and pure-decode windows alternated
``--decode-pairs`` times plus one profiled window of each.  Fails unless
every load window's tokens are bitwise equal.  Prints the card and one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--decode-pairs", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serving_overlap_ab: no CUDA device available",
              file=sys.stderr)
        return 2
    from distributed_pytorch_tpu_torch import serve
    from distributed_pytorch_tpu_torch.models import transformer as tfm
    from distributed_pytorch_tpu_torch.ops import _build
    facts = cs.card_facts(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(("decode_attention",))
    _build.load_library("decode_attention")
    port = {"tfm": tfm, "serve": serve, "cfg": tfm.PRESETS["LM-base"],
            "dev": "cuda"}
    load = cs.phase5_load(port["cfg"], 16, (64, 256))
    res = cs.overlap_windows(torch, port, load, pairs=args.pairs,
                             decode_pairs=args.decode_pairs,
                             profile_load=True)
    print(f"card: {facts['smi']}")
    print("serving_overlap_ab: " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
