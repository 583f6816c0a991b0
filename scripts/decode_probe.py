#!/usr/bin/env python3
"""Build and check the port's decode-attention kernel on one CUDA GPU, then
time it against SDPA: chip_smoke.py's phases 2, 3 and 9 without the serving
loads, for work on the decode kernel.  Run from the repository root:

    python3 scripts/decode_probe.py [--depths 0,255,1023,2047]

First every decode_kernel instance's ptxas report and a few small cases
(one launch each, the error against the plain version printed before any
gate); then chip_smoke.check_kernels and check_paged_kernels (every case
of phases 3 and 9, each launch repeated bitwise); then K6, K7, K8 and K9
at the timed shape against SDPA in alternated windows.  ``--depths`` times
K6 and K7 with every sequence at each depth: the kernel's fixed cost
(depth 0) and its streaming rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

SMALL = (  # (b, h, hkv, s, d, qdtype, quant, pos)
    (2, 2, 2, 300, 128, "bfloat16", False, [5, 299]),
    (2, 2, 2, 300, 128, "bfloat16", True, [40, 299]),
    (2, 8, 2, 300, 64, "bfloat16", True, [0, 257]),
    (1, 1, 1, 2048, 128, "float32", False, [2047]),
)


def small_cases(torch, attn) -> bool:
    """One launch of each SMALL case against the plain version; prints the
    error and returns False at the first launch that raises."""
    for i, (b, h, hkv, s, d, qd, quant, pos) in enumerate(SMALL):
        case = cs.make_case(torch, b=b, h=h, hkv=hkv, s=s, d=d,
                            qdtype=getattr(torch, qd), quant=quant, pos=pos,
                            seed=i)
        try:
            out, ref = cs.run_case(attn, case)
            torch.cuda.synchronize()
        except RuntimeError as e:  # a launch or a fault: report, stop
            print(f"  small case {i}: {e}", flush=True)
            return False
        err, ratio = cs.agreement(torch, out, ref)
        rows = (out.float() - ref.float()).abs().amax(-1).flatten().tolist()
        print(f"  small case {i} ({qd}, int8={quant}, B={b} H={h} Hkv={hkv} "
              f"S={s} D={d} pos={pos}): max_abs_err {err:.3e}, err/tol "
              f"{ratio:.3f}, per row {[round(x, 4) for x in rows]}",
              flush=True)
    return True


def time_all(torch, F, attn, facts) -> dict:
    out = {}
    for name, quant in (("K6", False), ("K7", True)):
        out[name] = cs.time_kernel(torch, F, attn, quant=quant,
                                   qdtype=torch.bfloat16, facts=facts)
    for name, quant in (("K8", False), ("K9", True)):
        out[name] = cs.time_paged_kernel(torch, F, attn, quant=quant,
                                         facts=facts)
    for name, t in out.items():
        print(f"  {name} timing: " + json.dumps(
            {k: t[k] for k in ("ms", "library_ms", "over_library",
                               "bound_ms", "bound_share", "plain_ms",
                               "host_us_per_call", "ms_windows",
                               "library_ms_windows", "split_len",
                               "n_splits")}))
        cs.print_decode_ratio(name, t, facts)
    return out


def depth_sweep(torch, attn, facts, depths) -> None:
    """K6 and K7 (bf16 q, B=8 x 8 kv heads x 128, S=2048) with every
    sequence at one depth: device ms and the live bytes' rate."""
    for depth in depths:
        for name, quant in (("K6", False), ("K7", True)):
            base = cs.make_case(torch, b=8, h=8, hkv=8, s=2048, d=128,
                                qdtype=torch.bfloat16, quant=quant,
                                pos=[depth] * 8, seed=5)
            per = sum(base[k].numel() * base[k].element_size()
                      for k in ("k", "v", "k_scale", "v_scale")
                      if base[k] is not None)
            n_rot = max(2, -(-int(200e6) // per))
            cases = [base] + [{k: (t.clone() if torch.is_tensor(t) else t)
                               for k, t in base.items()}
                              for _ in range(n_rot - 1)]
            it = iter(range(10 ** 9))

            def run():
                c = cases[next(it) % n_rot]
                attn.decode_attention(c["q"], c["k"], c["v"], c["pos"],
                                      k_scale=c["k_scale"],
                                      v_scale=c["v_scale"])

            ms = cs.time_ms(torch, run, iters=30)
            rows = (depth + 1) * 8 * 8
            nbytes = rows * 128 * 2 * (1 if quant else 2) \
                + (rows * 8 if quant else 0)
            print(f"  depth {depth:4d} {name}: {ms:.4f} ms, "
                  f"{nbytes / ms / 1e6:.0f} GB/s of live cache; "
                  f"{facts['smi']}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depths", default="",
                    help="comma-separated uniform depths to time K6, K7 at")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device available", file=sys.stderr)
        return 2
    from distributed_pytorch_tpu_torch.ops import _build
    from distributed_pytorch_tpu_torch.ops import attention as attn
    facts = cs.card_facts(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device {facts['name']}; nvidia-smi: {facts['smi']}; torch "
          f"{torch.__version__} (CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    _build.build_all(["decode_attention"])
    print(f"built decode_attention in {time.perf_counter() - t0:.1f} s")
    cs.decode_build_report(_build, facts)
    if not small_cases(torch, attn):
        return 1
    cs.check_kernels(torch, attn)
    cs.check_paged_kernels(torch, attn)
    time_all(torch, F, attn, facts)
    if args.depths:
        depth_sweep(torch, attn, facts,
                    [int(x) for x in args.depths.split(",")])
    print(f"card: {facts['smi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
