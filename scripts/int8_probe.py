#!/usr/bin/env python3
"""Build and check the port's int8 matmul kernel (K5) on one CUDA GPU, then
time it: chip_smoke.py's phase 15 without the rest, for work on K5.  Run
from the repository root:

    python3 scripts/int8_probe.py [--no-check] [--no-time]

First the ptxas report of the sm90 instances, and small cases of each route
with unit scales (the output is then the integer sum itself), whose
mismatches are split by row within the 64-row warpgroup tile and by column
within an 8-column accumulator group (a wrong swizzle, descriptor or
fragment mapping shows as a pattern there); then chip_smoke.check_int8_kernel
(every case, both output dtypes, both routes on the main shapes, 52
back-to-back launches) and chip_smoke.time_int8 (the sm90 route against the
mma_sync route in alternated windows, torch._int_mm alone and with the
epilogue, the bounds).  To compare two versions of the kernel, unpack each
tree into a git-ignored directory and run each tree's copy of this script
in turns in one call (A B B A, ``--no-check`` after the first).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def diagnose(torch, qz, *, m: int, k: int, n: int, route: str,
             out: str) -> dict:
    """One K5 launch with sx = sw = 1 against the exact integer product:
    the mismatch count, split by row mod 64 and column mod 8, and the
    first few mismatching (row, column, got, want)."""
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    qx = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    qwt = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                        dtype=torch.int8)
    ones_m = torch.ones(m, device="cuda")
    ones_n = torch.ones(n, device="cuda")
    odt = getattr(torch, cs.K5_OUT[out])
    got = qz.int8_matmul_q(qx, qwt, ones_m, ones_n, odt, route=route)
    want = qz._int_product(qx, qwt.t()).float().to(odt)
    torch.cuda.synchronize()
    bad = got != want
    rows, cols = bad.nonzero(as_tuple=True)
    first = [(int(r), int(c), float(got[r, c]), float(want[r, c]))
             for r, c in zip(rows[:6].tolist(), cols[:6].tolist())]
    return {"m": m, "k": k, "n": n, "route": route, "out": out,
            "mismatches": int(bad.sum()),
            "by_row_mod64": [int(x) for x in
                             torch.bincount(rows % 64, minlength=64)
                             .tolist()] if len(rows) else [],
            "by_col_mod8": [int(x) for x in
                            torch.bincount(cols % 8, minlength=8).tolist()]
            if len(cols) else [],
            "first": first}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("int8_probe: no CUDA device available", file=sys.stderr)
        return 2
    from distributed_pytorch_tpu_torch.ops import _build
    from distributed_pytorch_tpu_torch.ops import quantized as qz
    facts = cs.card_facts(torch)
    print(f"device {facts['name']}; nvidia-smi: {facts['smi']}; torch "
          f"{torch.__version__} (CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    _build.build_all(["int8_matmul"])
    print(f"built int8_matmul in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_info["int8_matmul"]["log"].splitlines():
        if "registers" in line or "spill" in line or "warning" in line:
            print("  " + line.strip())
    cs.int8_build_report(_build, facts)
    bad = 0
    for m, k, n in ((128, 128, 256), (256, 512, 512), (200, 1040, 304)):
        for route in ("sm90", "mma_sync"):
            for out in cs.K5_OUT:
                try:
                    d = diagnose(torch, qz, m=m, k=k, n=n, route=route,
                                 out=out)
                except RuntimeError as e:  # a launch or a fault: stop
                    print(f"  diagnose {m}x{k}x{n} {route} {out}: {e}",
                          flush=True)
                    return 1
                bad += d["mismatches"] > 0
                print("  diagnose: " + json.dumps(d), flush=True)
    if bad:
        print(f"int8_probe: {bad} diagnose cases mismatch")
        return 1
    if not args.no_check:
        cs.check_int8_kernel(torch, qz)
    if not args.no_time:
        cs.time_int8(torch, qz, facts)
    print(f"card: {facts['smi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
