#!/usr/bin/env python3
"""Build and check the port's flash-attention kernels on one CUDA GPU, then
time them against SDPA: chip_smoke.py's phases 2 and 6 without the rest,
for work on the flash kernels.  Run from the repository root:

    python3 scripts/flash_fwd_probe.py [--no-check] [--no-time]
        [--bwd-only] [--sweep]

First, for each head dim, small bf16 cases of the forward (K2) and of the
backward (K3's dq, K4's dk and dv) against their plain versions, with the
error split by 8-column group and by row within a tile (a wrong
shared-memory layout or descriptor shows as a pattern there); then
chip_smoke.check_flash (every case, each kernel bitwise against itself)
and chip_smoke.time_flash (K2 and SDPA's forward, K3, K4, K3 + K4 and
delta + K3 + K4 against SDPA's backward, all in alternated windows).
``--bwd-only`` diagnoses and times the backward alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def _split(err, rows) -> dict:
    """An error tensor (BH, S, D) split by 8-column group, by row mod 16
    (a warp's rows), and by 64-row half of each 128-row work tile."""
    s = err.shape[1]
    return {"max_err": err.max().item(),
            "by_col8": [round(x, 4) for x in
                        err.amax(dim=(0, 1)).view(-1, 8).amax(-1).tolist()],
            "by_row_mod16": [round(err[:, rows % 16 == r].max().item(), 4)
                             for r in range(16) if s > r],
            "by_half_tile": [round(err[:, (rows % 128) // 64 == h].max()
                                   .item(), 4) for h in range(2)
                             if s > 64 * h]}


def diagnose(torch, attn, *, bh: int, s: int, d: int, causal: bool) -> dict:
    """One bf16 forward against the plain version: the worst lse error, and
    o's error split as ``_split`` does."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o, lse = attn.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = attn.flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    rows = torch.arange(s, device="cuda")
    return {"bh": bh, "s": s, "d": d, "causal": causal,
            "lse_max_err": (lse - rlse).abs().max().item(),
            "o": dict(_split((o.float() - ro.float()).abs(), rows),
                      ref_max=ro.float().abs().max().item())}


def diagnose_bwd(torch, attn, *, bh: int, s: int, d: int, causal: bool,
                 dlse: bool) -> dict:
    """One bf16 backward (K3 and K4 on the plain forward's lse) against
    ``flash_attention_bwd_plain``: dq, dk and dv errors, each split as
    ``_split`` does, beside each reference's largest magnitude."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = attn.flash_attention_fwd_plain(q, k, v, causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    if dlse:
        delta = delta - torch.randn((bh, s), generator=gen, device="cuda")
    dq = attn.flash_attention_bwd_dq(q, k, v, lse, do, delta, causal=causal)
    dk, dv = attn.flash_attention_bwd_dkv(q, k, v, lse, do, delta,
                                          causal=causal)
    want = attn.flash_attention_bwd_plain(q, k, v, lse, do, delta,
                                          causal=causal)
    torch.cuda.synchronize()
    rows = torch.arange(s, device="cuda")
    out = {"bh": bh, "s": s, "d": d, "causal": causal, "dlse": dlse}
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        out[name] = dict(_split((got.float() - ref.float()).abs(), rows),
                         ref_max=ref.float().abs().max().item())
    return out


SWEEP = ((64, 1024, True), (64, 1024, False), (16, 4096, True),
         (16, 4096, False), (128, 512, True))


def sweep(torch, F, attn, facts) -> None:
    """K2 and SDPA's forward (alternated) at D = 128 over (B*H, S, causal)
    shapes: ms and TFLOP/s of each (causal counts the live half)."""
    for bh, s, causal in SWEEP:
        gen = torch.Generator(device="cuda").manual_seed(3)
        q, k, v = (torch.randn((bh, s, 128), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        q4, k4, v4 = (t.view(1, bh, s, 128) for t in (q, k, v))
        fns = {"K2": lambda: attn.flash_attention_fwd(q, k, v,
                                                     causal=causal),
               "SDPA": lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, is_causal=causal)}
        ms = {"K2": [], "SDPA": []}
        for name in ("K2", "SDPA", "SDPA", "K2"):
            ms[name].append(cs.time_ms(torch, fns[name], iters=30))
        pairs = bh * s * (s + 1) // 2 if causal else bh * s * s
        flops = 4 * pairs * 128
        k2, lib = (sum(ms[n]) / 2 for n in ("K2", "SDPA"))
        print(f"  sweep BH={bh} S={s} causal={causal:d}: K2 {k2:.4f} ms "
              f"({flops / k2 / 1e9:.0f} TFLOP/s), SDPA {lib:.4f} ms "
              f"({flops / lib / 1e9:.0f} TFLOP/s), K2/SDPA {k2 / lib:.3f}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K2 and SDPA over the SWEEP shapes")
    ap.add_argument("--bwd-only", action="store_true",
                    help="diagnose and time the backward (K3, K4) alone")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_fwd_probe: no CUDA device available", file=sys.stderr)
        return 2
    from distributed_pytorch_tpu_torch.ops import _build
    from distributed_pytorch_tpu_torch.ops import attention as attn
    facts = cs.card_facts(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device {facts['name']}; nvidia-smi: {facts['smi']}; torch "
          f"{torch.__version__} (CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    _build.build_all(["flash_attention"])
    print(f"built flash_attention in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_info["flash_attention"]["log"].splitlines():
        if "registers" in line or "spill" in line or "warning" in line:
            print("  " + line.strip())
    cs.sm90_build_report(_build, facts)
    for d in (64, 128):
        for s, causal in ((128, False), (200, True)):
            try:
                if not args.bwd_only:
                    print("  diagnose: " + json.dumps(diagnose(
                        torch, attn, bh=2, s=s, d=d, causal=causal)),
                        flush=True)
                print("  diagnose backward: " + json.dumps(diagnose_bwd(
                    torch, attn, bh=2, s=s, d=d, causal=causal,
                    dlse=causal)), flush=True)
            except RuntimeError as e:  # a launch or a fault: report, stop
                print(f"  diagnose D={d} S={s}: {e}", flush=True)
                return 1
    if not args.no_check:
        cs.check_flash(torch, attn)
    if not args.no_time:
        timing = cs.time_flash(torch, F, attn, facts,
                               bwd_only=args.bwd_only)
        for name, t in timing.items():
            print(f"  {name} timing (bf16, B=8 H=8 S=1024 D=128 causal): "
                  + json.dumps(t))
        cs.print_flash_ratios(timing, facts)
    if args.sweep:
        sweep(torch, F, attn, facts)
    print(f"card: {facts['smi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
