#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch/CUDA port (distributed_pytorch_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. card facts (name, power limit, torch version); TF32 off;
  2. build the port's CUDA kernels from csrc/; the bf16 flash kernels'
     registers, spills and shared memory from ptxas (no spill allowed),
     and every decode instance's;
  3. the decode kernels (K6, K7) against their plain PyTorch version on
     the card, on the main path's shapes plus ragged / tile-edge /
     garbage-past-pos cases and the split plan's edges (depths on both
     sides of every split edge, a short sequence beside full-depth ones,
     one (b, h) with every split live), each launch repeated 51 times
     bitwise equal; timed beside their bound and plain version, and
     against SDPA in alternated windows;
  4. LM-base in float32: the continuous batcher's greedy tokens against
     static generate() per request, and the first decode step's logits
     through the kernel against the plain path;
  5. LM-base in bfloat16: a serving run of 16 requests through 8 slots
     (decode kernel K6), and a shorter one with an int8 KV cache (K7);
     the launch counts show the main path went through the kernel;
  6. the flash-attention kernels (K2 forward, K3 dQ, K4 dK/dV) against
     their plain versions (f32 and bf16, head dims 64 and 128, causal or
     not, ragged lengths, an lse cotangent, the training shape, and the
     bf16 forward's tile edges: lengths 1 to 2048 around its 64- and
     128-row tiles, 256 queries over 1000 keys; K2 run twice, bitwise
     equal), timed at the training shape beside their bounds, plain
     versions and SDPA (K2 and SDPA's forward in alternated windows);
  7. one LM-base-width float32 train step (2 layers) through the flash
     kernels against the same step through reference attention;
  8. LM-base (24 layers, byte vocabulary) trained 30 steps through lm_cli
     at batch 8 x 1024 in bf16: ms/step, tokens/s, peak memory, the
     device's idle share, mfu, K2's share of the device time, falling
     loss, and K2/K3/K4 launched once per layer per step;
  9. the paged decode kernels (K8, K9) against their plain versions over
     shuffled pools with poisoned table tails and garbage in unowned pages
     (f32, bf16 and int8 pools, head dims 64 and 128, g 1 and 4, and
     phase 3's split edges), bitwise equal to K6/K7 over the same rows
     laid out contiguously and to themselves over 52 launches, and timed
     at the serving shape beside their bound and plain versions, and
     against SDPA in alternated windows;
 10. LM-base in float32 through the paged batcher: an oversubscribed pool
     (evictions and swap-ins), shared-prefix admissions and in-block
     refill handoffs against static generate() per request (the handoffs
     also against K8's plain version, tokens equal), and one decode
     step's logits through K8 against the plain paged path;
 11. LM-base bf16 paged serving: phase 5's load on the default pool
     without compaction (tokens equal to phase 5's, request by request),
     with compaction, on an oversubscribed pool, the int8 pool (K9), and a
     shared-system-prompt load with and without the prefix cache; every
     decode step through K8/K9 once per layer and never through K6/K7;
 12. the fused BN+ReLU backward kernels (K1a sums, K1b da) against their
     plain version on the eight VGG-11 batch-256 BN shapes and TINY widths
     (f32 and bf16), row counts no block size divides, and rows whose
     forward y lands on 0 or an ulp from it: masks element for element,
     two runs bitwise equal; timed per layer beside their byte bounds, the
     plain closed form and aten's native_batch_norm_backward;
 13. a VGG-11 f32 train step with fused_bn=True against the plain one on
     the same weights and batch (loss bitwise, gradients and the params
     after 10 SGD steps within stated bounds, K1a/K1b once per BN layer),
     then alternated fused/plain bf16 windows (ms/step, device time, idle
     share, peak memory);
 14. VGG-11 one epoch of synthetic CIFAR-10 through the port's cli (f32 at
     --strategy none, bf16 at the default ddp over a one-rank NCCL group):
     the reference's time windows, samples/s, mfu, idle share, falling
     loss and test accuracy above chance, no process group left after;
 15. the int8 matmul kernel (K5) against its plain version, in float32
     and bf16 output: the three LM-base shapes at m=8192 (bf16 and f32
     inputs; through its sm90 route and its mma_sync route), 33x77 @
     77x19, m=8191, k=1000, n=4100, k=1040, a zero row and rows at +-127,
     bitwise in every case, the route each took, two runs bitwise equal,
     52 back-to-back launches bitwise at two shapes; the sm90 instances'
     ptxas report (no spill, no stack); timed per shape, the sm90 route
     against the mma_sync route in alternated windows, beside the bound of
     each output dtype, the plain integer product, torch._int_mm alone
     and with the epilogue;
 16. LM-base bf16 trained 30 steps through lm_cli --matmul-dtype int8 (as
     phase 8: ms/step, tokens/s, idle share, peak memory, device
     operations a step, mfu over the bf16 peak, falling loss; K5 launched
     7 x 24 times per step, every launch through its sm90 route, and
     K2/K3/K4 24), alternated int8/bf16 windows (2 pairs x 10 steps) and
     the int8-vs-bf16 argmax flip rate (reported), and one 2-layer
     LM-base-width f32 int8 step through K5 against the plain product
     (loss bitwise, gradients within the spread of two K5 runs);
 17. LM-base bf16 3 steps through lm_cli with --remat none / full /
     selective (step-1 loss bitwise equal, grad-norm within 1e-3, peak
     memory, K2 launched twice per layer under full remat and once under
     selective), full against selective in alternated 5-step windows (K2's
     launches per window, one profiled step of each), and head_loss dense
     against chunked at vocab 32,000, B=8 x S=1024 x 1024 (loss within
     1e-5, gradients, time and peak memory);
 18. serving scheduling at LM-base width: (a) f32 against static
     generate() per request, with near-ties allowed as in phase 4: the
     batcher with prefill_chunk=64 and with speculate=4 (dense and paged),
     generate_lookup, and generate_speculative with a 2-layer draft
     (acceptance reported); (b) bf16 overlapped dispatch on against off on
     phase 5's load, one window a side, the on side phase 5's run
     (tokens/s, wall ms per decode step,
     chained dispatches; tokens bitwise equal), and in
     pure-decode windows where every block chains (wall ms per decode
     step; idle share and device operations per emitted token from one
     profiled window a side; scripts/serving_overlap_ab.py also profiles
     the load); (c) phase 5's load with in-block refill off
     against phase 5's run (utilization, refills, tokens/s, TTFT; bf16
     token flips counted); (d) speculate=4 against 0 on a lookup-friendly
     load (acceptance, emissions per slot-step, verify rounds per token;
     no decode-kernel launch in the speculative run); (e) phase 5's load
     with prefill_chunk=128 against phase 5's run (TTFT, tokens/s);
 19. data-parallel VGG-11 at world size 1 over a one-rank NCCL group, bf16,
     batch 256: every strategy on one saved set of gradients (the exact
     ones and the rings bitwise, quantized within half a quantum), 20
     steps each (the exact ones within the spread of two plain runs, the
     others a falling loss), the collectives one step issues by strategy
     (gated: 34 all-reduces for all_reduce, one a bucket for bucketed, 68
     for quantized, one for ddp), ddp against none in A B B A windows,
     and ddp with fused_bn=True (K1a/K1b 8 a step, params within the
     spread of two plain fused runs);
 20. MoE and LM data parallel at LM-base width with --n-experts 8 (12 MoE
     layers of 8 experts, top-1, capacity factor 2): (a) f32 moe_apply at
     T=8192 against its one-hot form on the card (top-1, top-2, expert
     choice, capacity factor 0.5; drop share), a 2-layer train step
     (layer 1 MoE) through flash against reference attention, the MoE
     batcher against static generate(); (b) 20 bf16 steps of lm_cli
     --n-experts 8 (as phase 8, mfu over the active parameters; the MoE
     layers' share of device time, aux and drop share; K2-K4 once per
     layer per step); (c) phase 5's 8-request load dense and paged (K6 /
     K8 once per layer per decode step); (d) lm_cli --rendezvous env --dp 1
     under launch.py over a one-rank NCCL group, losses bitwise equal to
     the run with no group, two all-reduces a step.
 21. the per-step sync knobs at world size 1 over a one-rank NCCL group,
     bf16: (a) VGG-11 overlap=True for every overlap-capable strategy and
     hierarchical's int8 and int4 hops, 10 steps each, bitwise the
     post-backward run (losses, params, BN state, residual); (b) one
     profiled overlapped ddp step in >= 3 buckets, each bucket's NCCL call
     but the last-due one issued before the backward's last compute node,
     and overlap against post-backward in A B B A windows (ms a step,
     idle share); (c) the ZeRO-3 gather's int8/int4 codec over every
     LM-base leaf and the dcn ring's codec with its EF update on
     LM-base's flat gradient, bitwise the plain codec and the CPU's, with
     their ms a step.
 22. the sync windows at world size 1 over a one-rank NCCL group: (a)
     VGG-11 local-SGD windows of 4 steps: plain SGD in f32 against the
     accumulated-update oracle in plain torch (atol 2e-4), a trivial outer
     optimizer bitwise the plain window, nesterov and momentum anchors and
     outer momentum bitwise a plain-torch outer step after each boundary,
     and momentum SGD under ddp, quantized_ring_ef and hierarchical int8
     in bf16 against their per-step runs (step 0's loss rtol 1e-5, the
     curve rtol 1e-1, the residual finite); (b) the NCCL calls of a
     profiled 8-step window run (two exchanges, no gradient sync in the
     local steps) against the per-step run's, and H=4 against H=1 in
     A B B A windows (ms a step, idle share); (c) the LM window arithmetic
     over LM-base's params: anchor + delta and the nesterov outer step,
     ms against their bytes bound, the outer step bitwise the CPU's on
     three leaves and the per-slice mask with the prescale bitwise the
     CPU's.
 23. observability at LM-base width, bf16, B=8 x S=1024: (a) lm_cli 12
     steps with --telemetry-dir and --profile-dir (a step span and three
     gauges a step, the loss gauges bitwise the returned losses, the
     merged trace strict JSON; the profiler trace of steps 2-11 holding
     K2, K3 and K4 240 times each); (b) LMTrainer.train_steps of 4 stacked
     batches bitwise 4 train_step calls; (c) telemetry off / on in A B B A
     windows (ms a step, device ops a step and idle share from profiled
     windows; losses bitwise, telemetry off adds no device operation to
     phase 8's step); (d) record_memory against max_memory_allocated and
     the trees' bytes; (e) evaluate_run with step_time p95 rules under and
     over the measured p95.
 24. checkpoints and faults at LM-base width, bf16, B=8 x S=1024: (a)
     launch.py --max-restarts 1 over lm_cli with phase 8's flags and
     --steps 30 --checkpoint-dir --checkpoint-every 10 --telemetry-dir, a
     FAULT_PLAN crash at step 15 in generation 0: one injected fault and
     one restart, generation 1 restoring step 10, its losses over steps
     11-30 (the telemetry's loss gauges) bitwise phase 8's, K2-K4 once per
     layer per step; each save's bytes, fetch and background write, the
     restore's ms; (b) the training sentry at 4 layers: NaN, Inf and
     loss-spike plans rolled back and skipped, bitwise the clean run
     without the window, the stats the predicted ones; a persistent NaN
     tightening the clip, then aborting with a sentry_abort postmortem; a
     snapshot's ms and sentry off / on ms a step, A B B A; (c) ckpt_corrupt
     plans (bitflip, truncate) on the whole-tree and sharded formats: the
     corrupt generation quarantined, the restore bitwise the previous save;
     (d) with no plan a step's device operations equal phase 8's, and a
     fired NaN tap adds only the poison's.
Phases 4, 5, 10, 11 and 18 run the batcher's defaults, in-block refill and
overlapped dispatch on, as the JAX batcher's are.
The second-to-last lines are the kernels' JSON record and the card's name
and power limit; the last line is {"ok": true, "device": {...}}.

Without a CUDA device, or without the port's package beside it, it exits
with a non-zero code and prints no result.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_facts(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi unavailable (rc {smi.returncode})"
    if "PCIe" in name:
        bw = 2.0e12
    elif "NVL" in name:
        bw = 3.9e12
    else:
        bw = 3.35e12   # H100 SXM (reported as "H100 80GB HBM3")
    return {"name": name, "smi": smi_line, "bw": bw,
            "count": torch.cuda.device_count()}


# Every torch.profiler window here records the device's activity alone:
# only its kernels and copies are read, and host-side events would
# multiply the time key_averages() takes to parse a window.

# Published dense peaks of one H100 SXM, operations per second.
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


def time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean DEVICE milliseconds per call: CUDA events around ``iters``
    calls that were all enqueued while the stream was held busy by a sleep
    kernel, so host-side enqueue time does not leak into the reading."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device time at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters: int = 200) -> float:
    """Mean host microseconds to enqueue one call (wrapper overhead)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


# -- phase 3: kernels against their plain versions -------------------------

DEVICE = "cuda"  # where make_case builds its tensors


def make_case(torch, *, b, h, hkv, s, d, qdtype, quant, pos, seed):
    rng = np.random.default_rng(seed)
    dev = DEVICE
    q = torch.from_numpy(rng.standard_normal((b, h, 1, d), np.float32)
                         ).to(dev, qdtype)
    k = torch.from_numpy(rng.standard_normal((b, hkv, s, d), np.float32)
                         ).to(dev)
    v = torch.from_numpy(rng.standard_normal((b, hkv, s, d), np.float32)
                         ).to(dev)
    case = {"q": q, "pos": torch.tensor(pos, dtype=torch.int32, device=dev)}
    if quant:
        from distributed_pytorch_tpu_torch.generate import quantize_kv
        case["k"], case["k_scale"] = quantize_kv(k)
        case["v"], case["v_scale"] = quantize_kv(v)
    else:
        case["k"], case["v"] = k.to(qdtype), v.to(qdtype)
        case["k_scale"] = case["v_scale"] = None
    return case


def run_case(attn, case):
    kw = dict(k_scale=case["k_scale"], v_scale=case["v_scale"])
    out = attn.decode_attention(case["q"], case["k"], case["v"], case["pos"],
                                **kw)
    ref = attn.decode_attention_plain(case["q"], case["k"], case["v"],
                                      case["pos"], **kw)
    return out, ref


# Kernel vs plain tolerance, compared in f32.  float32: both sides compute
# in f32 and differ only in summation order -> 1e-5 absolute.  bfloat16
# (and int8 dequantized to bf16): both sides round p to bf16 at different
# running maxima of the online softmax (relative 2^-8 per weight) and round
# the output to bf16 (one ulp, <= 2^-7 of |o|), so the error scales with
# the output row's size: at most 5% of the row's RMS, and never above 1e-2.
# A deep row (|o| ~ 0.05 at depth ~1000) is thus held to ~2.5e-3, which a
# dropped or misweighted tile of a few percent of the softmax mass exceeds.
TOL_ABS = {"float32": 1e-5, "bfloat16": 1e-2}
TOL_ROW_RMS = {"float32": None, "bfloat16": 5e-2}


def agreement(torch, out, ref) -> tuple[float, float]:
    """(max abs error, worst error / tolerance) of ``out`` against ``ref``
    (B, H, 1, D); the tolerance is per (sequence, head) row."""
    dt = str(out.dtype)[6:]
    err = (out.float() - ref.float()).abs()
    bound = torch.full_like(err, TOL_ABS[dt])
    if TOL_ROW_RMS[dt] is not None:
        rms = ref.float().pow(2).mean(-1, keepdim=True).sqrt()
        bound = torch.minimum(bound, (TOL_ROW_RMS[dt] * rms).clamp_min(1e-6))
    ratio = (err / bound).max().item()
    if not bool(torch.isfinite(out).all()):
        ratio = math.inf
    return err.max().item(), ratio


def repeat_bitwise(torch, fn, first, name: str, n: int = 50) -> None:
    """``fn`` (one launch) run again, then ``n`` times back to back: each
    output bitwise equal to ``first``.  An arrival counter left non-zero by
    one launch, or a merge whose order followed the arrivals, shows here."""
    again = fn()
    outs = [fn() for _ in range(n)]
    torch.cuda.synchronize()
    if not torch.equal(again, first):
        fail(f"{name}: two runs differ")
    bad = [i for i, o in enumerate(outs) if not torch.equal(o, first)]
    if bad:
        fail(f"{name}: {len(bad)} of {n} back-to-back launches differ from "
             f"the first (the first at launch {bad[0]})")


def split_cases(torch, s: int = 2048) -> list[tuple[dict, list[int]]]:
    """The split plan's edges: at B=8 x 8 kv heads x 128 (L = 256 slots
    a split) depths on both sides of every split edge, and a short
    sequence beside full-depth ones (its later splits empty); one (b, h)
    at full depth, all splits live (L = 32: 64 splits merged), at g = 1
    and 4.  Each shape in f32 and bf16, bf16 and int8 caches."""
    out = []
    edges = [e + o for e in range(256, s, 256) for o in (-1, 0)]
    for qdtype in (torch.float32, torch.bfloat16):
        for quant in (False, True):
            big = dict(b=8, h=8, hkv=8, s=s, d=128, qdtype=qdtype,
                       quant=quant)
            out.append((big, edges[:8]))
            out.append((big, edges[8:] + [s - 1, 256 + 1]))
            out.append((big, [s - 1, s - 1, 3, s - 1, 0, s - 1, 40, s - 1]))
            for h, d in ((1, 128), (4, 64)):
                out.append((dict(b=1, h=h, hkv=1, s=s, d=d, qdtype=qdtype,
                                 quant=quant), [s - 1]))
    return out


def check_kernels(torch, attn) -> dict:
    """Every case of the kernel against the plain version, each launch
    repeated (``repeat_bitwise``); returns the worst error per kernel (K6 /
    K7) and the worst error/tolerance."""
    worst = {"K6": 0.0, "K7": 0.0}
    worst_ratio = {"K6": 0.0, "K7": 0.0}
    cases = []
    for qdtype in (torch.float32, torch.bfloat16):
        for d in (128, 64):
            for g in (1, 4):
                cases.append(dict(b=4, h=4 * g, hkv=4, s=1000, d=d,
                                  qdtype=qdtype, quant=False))
        # the serving path's shapes: LM-base (8 slots x 8 heads x 128) over
        # a 2048-slot cache, both cache types
        for quant in (False, True):
            cases.append(dict(b=8, h=8, hkv=8, s=2048, d=128,
                              qdtype=qdtype, quant=quant))
        cases.append(dict(b=4, h=8, hkv=2, s=1000, d=64, qdtype=qdtype,
                          quant=True))
    # ragged pos: 0, the last slot of a tile, the first of the next, S-1,
    # and mid-cache depths
    cases = [(sh, ([0, 31, 32, sh["s"] - 1]
                   + [100 + 37 * j for j in range(sh["b"])])[:sh["b"]])
             for sh in cases] + split_cases(torch)
    for i, (sh, pos) in enumerate(cases):
        s, b = sh["s"], sh["b"]
        case = make_case(torch, pos=pos, seed=i, **sh)
        out, ref = run_case(attn, case)
        torch.cuda.synchronize()
        err, ratio = agreement(torch, out, ref)
        name = "K7" if sh["quant"] else "K6"
        worst[name] = max(worst[name], err)
        worst_ratio[name] = max(worst_ratio[name], ratio)
        split_len = attn.decode_split_plan(b, sh["hkv"], sh["h"] // sh["hkv"],
                                           s)[0]
        print(f"  {name} {str(sh['qdtype'])[6:]:8s} D={sh['d']:3d} "
              f"g={sh['h'] // sh['hkv']:2d} B={b} S={s} L={split_len} "
              f"pos={pos}: max_abs_err {err:.3e}, err/tol {ratio:.3f}")
        if not ratio <= 1.0:
            fail(f"{name} disagrees with decode_attention_plain: {err} "
                 f"({ratio} x the tolerance)")
        repeat_bitwise(torch, lambda: attn.decode_attention(
            case["q"], case["k"], case["v"], case["pos"],
            k_scale=case["k_scale"], v_scale=case["v_scale"]), out,
            f"{name} case {i}")
        # garbage past pos: a dead tail of +-1e4 must not change the output
        k2, v2 = case["k"].clone(), case["v"].clone()
        fill = 100 if sh["quant"] else 1e4
        for j, p in enumerate(pos):
            k2[j, :, p + 1:] = fill
            v2[j, :, p + 1:] = -fill
        dirty = attn.decode_attention(case["q"], k2, v2, case["pos"],
                                      k_scale=case["k_scale"],
                                      v_scale=case["v_scale"])
        if not torch.equal(dirty, out):
            fail(f"{name}: garbage past pos changed the output")
    print(f"  all {len(cases)} cases within tolerance; each bitwise equal "
          f"to itself over 52 launches; garbage past pos changed no output")
    return {"max_abs_err": worst, "err_over_tol": worst_ratio}


def alternated(torch, kernel, library, iters: int = 30) -> dict:
    """A kernel and its library yardstick timed in turns (kernel, library,
    library, kernel, twice): the mean of each, every window, and the mean
    of the per-pair ratios kernel / library."""
    windows = {"kernel": [], "library": []}
    fns = {"kernel": kernel, "library": library}
    for name in ("kernel", "library", "library", "kernel") * 2:
        windows[name].append(time_ms(torch, fns[name], iters=iters))
    ratios = [a / b for a, b in zip(windows["kernel"], windows["library"])]
    return {"ms": float(np.mean(windows["kernel"])),
            "library_ms": float(np.mean(windows["library"])),
            "ms_windows": windows["kernel"],
            "library_ms_windows": windows["library"],
            "over_library": float(np.mean(ratios))}


def time_kernel(torch, F, attn, *, quant: bool, qdtype, facts) -> dict:
    """Kernel, plain and library times at the LM-base decode shape: 8
    slots x 8 kv heads x head_dim 128, a 2048-slot cache, ragged depths
    drawn from [64, 1984] (seeded).  Caches rotate over enough copies to
    exceed the 50 MB L2, as the 24 layers of a decode step do.  The kernel
    and SDPA are timed in alternated windows."""
    b, h, hkv, s, d = 8, 8, 8, 2048, 128
    rng = np.random.default_rng(7)
    pos = [int(p) for p in rng.integers(64, 1985, b)]
    base = make_case(torch, b=b, h=h, hkv=hkv, s=s, d=d, qdtype=qdtype,
                     quant=quant, pos=pos, seed=99)
    # the timed inputs are checked too: deep ragged rows at the path's shape
    out, ref = run_case(attn, base)
    err, ratio = agreement(torch, out, ref)
    if not ratio <= 1.0:
        fail(f"decode_attention disagrees with decode_attention_plain on "
             f"the timed case: {err} ({ratio} x the tolerance)")
    per = sum(t.numel() * t.element_size() for t in
              (base["k"], base["v"], base["k_scale"], base["v_scale"])
              if t is not None)
    n_rot = max(2, math.ceil(200e6 / per))
    cases = [base] + [{key: (t.clone() if torch.is_tensor(t) else t)
                       for key, t in base.items()} for _ in range(n_rot - 1)]
    it = iter(range(10 ** 9))

    def kernel():
        c = cases[next(it) % n_rot]
        attn.decode_attention(c["q"], c["k"], c["v"], c["pos"],
                              k_scale=c["k_scale"], v_scale=c["v_scale"])

    def plain():
        c = cases[next(it) % n_rot]
        attn.decode_attention_plain(c["q"], c["k"], c["v"], c["pos"],
                                    k_scale=c["k_scale"],
                                    v_scale=c["v_scale"])

    # library yardstick: SDPA over the dense (dequantized) cache with a
    # boolean pos mask; timed only, never called by the port
    slot = torch.arange(s, device="cuda")
    mask = (slot[None, :] <= base["pos"][:, None].long())[:, None, None, :]
    dense = []
    for c in cases:
        kd, vd = c["k"], c["v"]
        if quant:
            kd = (kd.float() * c["k_scale"]).to(qdtype)
            vd = (vd.float() * c["v_scale"]).to(qdtype)
        dense.append((c["q"], kd, vd))

    def library():
        qq, kd, vd = dense[next(it) % n_rot]
        F.scaled_dot_product_attention(qq, kd, vd, attn_mask=mask)

    launches0 = attn.decode_attention.launches
    res = alternated(torch, kernel, library)
    wrapper_us = host_us(torch, kernel)
    attn.decode_attention.launches = launches0  # timing launches not counted
    plain_ms = time_ms(torch, plain, iters=10)
    rows = sum(p + 1 for p in pos) * hkv
    itemsize = 1 if quant else torch.empty((), dtype=qdtype).element_size()
    qsize = torch.empty((), dtype=qdtype).element_size()
    nbytes = (rows * d * 2 * itemsize + (rows * 8 if quant else 0)
              + 2 * b * h * d * qsize + 4 * b)
    ops = 4 * d * sum(p + 1 for p in pos) * h
    t_bytes = nbytes / facts["bw"] * 1e3
    t_ops = ops / PEAK_OPS[str(qdtype)[6:]] * 1e3
    bound = max(t_bytes, t_ops)
    split_len, n_splits = attn.decode_split_plan(b, hkv, h // hkv, s)[:2]
    res.update({"plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_share": bound / res["ms"], "bytes": nbytes,
                "host_us_per_call": wrapper_us, "pos": pos,
                "split_len": split_len, "n_splits": n_splits,
                "max_abs_err": err, "err_over_tol": ratio})
    return res


# -- phases 4 and 5: the slice ---------------------------------------------

def greedy_refs(port, params, prompts, max_new) -> list:
    """Static generate()'s greedy output for each prompt."""
    gen, cfg, dev = port["gen"], port["cfg"], port["dev"]
    wants = []
    for p in prompts:
        want = gen.generate(params, p[None], cfg=cfg, max_new=max_new,
                            temperature=0.0, device=dev)[0].cpu().numpy()
        if not np.isfinite(want).all() or len(want) != len(p) + max_new:
            fail("generate() output malformed")
        wants.append(want)
    return wants


def check_greedy(torch, port, params, prompts, got, max_new,
                 label: str, wants=None) -> int:
    """Each request's tokens ``got[rid]`` against static generate()
    (``wants``, from ``greedy_refs``, when given); a difference is allowed
    only at a near-tie (top-2 logit gap < 1e-3) of the reference stream's
    first diverging position.  Returns the number of such flips."""
    import dataclasses
    tfm, cfg, dev = port["tfm"], port["cfg"], port["dev"]
    if wants is None:
        wants = greedy_refs(port, params, prompts, max_new)
    if cfg.n_experts:
        # decode's MoE mixes every expert with no capacity: the training
        # forward drops nothing at a capacity factor of E either
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    flips = 0
    for rid, (p, want) in enumerate(zip(prompts, wants)):
        if len(got[rid]) != len(want):
            fail(f"{label}: request {rid} has {len(got[rid])} tokens, "
                 f"want {len(want)}")
        diff = np.nonzero(got[rid] != want)[0]
        if len(diff):
            t = int(diff[0])
            logits = tfm.apply(params, torch.from_numpy(
                want[:t].astype(np.int64))[None].to(dev), cfg=cfg,
                attn_impl="reference")[0, -1]
            top2 = torch.topk(logits, 2).values
            gap = float(top2[0] - top2[1])
            print(f"  {label} request {rid}: first divergence at {t}, "
                  f"top-2 logit gap {gap:.3e}")
            if gap > 1e-3:
                fail(f"{label}: batcher tokens differ from generate() for "
                     f"request {rid} at {t} with a top-2 gap of {gap}")
            flips += 1
    return flips


def sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def exactness(torch, port) -> None:
    tfm, gen = port["tfm"], port["gen"]
    cfg, dev = port["cfg"], port["dev"]
    params = tfm.init(0, cfg, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(1)
    lens, max_new = (7, 45, 130, 300), 24
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    cb = port["serve"].ContinuousBatcher(
        params, cfg, slots=2, max_len=512, temperature=0.0,
        prompt_buckets=(64, 512), device=dev)
    got = cb.run(prompts, max_new=max_new)
    flips = check_greedy(torch, port, params, prompts, got, max_new,
                         "dense batcher")
    print(f"  f32 batcher vs static generate: {len(prompts)} requests, "
          f"{flips} near-tie flips")
    # first decode step's logits: kernel vs plain path, same prefilled cache
    b, s0 = 4, 200
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s0))).to(dev)
    cache = gen.init_cache(cfg, b, 512, device=dev)
    logits, cache = gen._forward_cached(params, cache, toks,
                                        torch.arange(s0, device=dev), 0,
                                        cfg=cfg, k_len=s0,
                                        unembed_last_only=True)
    tok = torch.argmax(logits[:, 0], -1)
    pos = torch.tensor([s0, s0 - 50, s0 - 120, 3], dtype=torch.int32,
                       device=dev)
    outs = []
    for kernel in (True, False):
        c2 = {n: {k: t.clone() for k, t in lyr.items()}
              for n, lyr in cache.items()}
        outs.append(gen.decode_step_ragged(params, c2, tok, pos, cfg=cfg,
                                           use_decode_kernel=kernel)[0])
    err = (outs[0] - outs[1]).abs().max().item()
    # f32 throughout; the two paths sum in different orders over 24 layers
    tol = 1e-3
    print(f"  first decode step logits, kernel vs plain: max_abs_err "
          f"{err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        fail(f"decode-step logits differ between kernel and plain: {err}")
    del params, cache
    torch.cuda.empty_cache()


def device_events(prof) -> dict[str, list]:
    """{name: [device us, count]} of the kernels, copies and sets a stopped
    CUDA-activity profile recorded, from its raw events: key_averages()
    first builds a Python event for each, ~150 us apiece on the card's
    host, minutes for a whole serving load (~1.5 M of them)."""
    from torch.autograd import DeviceType
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_hidden_event():
            acc = by_name.setdefault(e.name(), [0.0, 0])
            acc[0] += e.duration_ns() / 1e3
            acc[1] += 1
    return by_name


def decode_window(torch, cb, prompts, n_blocks: int, profiled: bool,
                  max_new: int = 64) -> dict:
    """Admit ``prompts`` into the drained batcher, run one block, then
    measure ``n_blocks`` decode blocks, and drain.  Greedy and from the
    same drained state, so every call runs the same work.

    Unprofiled: wall ms per decode step.  Profiled (torch.profiler): device
    ms per decode step and device operations (kernels and copies) per step,
    summed over CUDA events (one stream, so they do not overlap), and the
    operations that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    if cb.pending():
        fail("decode window started on a busy batcher")
    for p in prompts:
        cb.submit(p, max_new=max_new)
    cb.step()  # admit and run one block
    sync(torch)
    steps0 = cb.stats["decode_steps"]
    prof = profile(activities=[ProfilerActivity.CUDA]) \
        if profiled else None
    t0 = time.perf_counter()
    if prof is not None:
        prof.start()
    for _ in range(n_blocks):
        cb.step()
    sync(torch)
    if prof is not None:
        prof.stop()
    wall = time.perf_counter() - t0
    steps = cb.stats["decode_steps"] - steps0
    while cb.pending():
        cb.step()
    res = {"decode_steps": steps, "wall_ms_per_decode_step":
           wall * 1e3 / max(steps, 1)}
    if prof is None:
        return res
    by_name = device_events(prof)
    total_us = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    res.update({
        "device_ms_per_decode_step": total_us / 1e3 / max(steps, 1),
        "device_ops_per_decode_step":
            sum(n for _, n in by_name.values()) / max(steps, 1),
        "top_kernels": [[name[:60], us / max(total_us, 1e-9),
                         n / max(steps, 1)] for name, (us, n) in top]})
    return res


def phase5_load(cfg, n_req: int, budgets: tuple[int, int]):
    """Phase 5's serving load: ``n_req`` prompts of 64-480 tokens and
    budgets drawn from ``budgets`` (seed 0)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(64, 481, n_req)]
    max_new = [int(m) for m in rng.integers(budgets[0], budgets[1] + 1,
                                            n_req)]
    return prompts, max_new


def serving_run(torch, port, *, label, prompts, max_new,
                window_blocks: int = 1, window_new: int = 64,
                **batcher_kw) -> dict:
    """One LM-base bf16 serving load through the batcher (8 slots x 2048,
    buckets (128, 512), 16 steps per block unless ``batcher_kw`` says
    otherwise): tokens/s, ms per decode step and per prefill, utilization,
    peak memory and the scheduler's counts over the whole run, then the
    device's idle share from three decode windows of ``window_blocks``
    blocks (none when 0).  Fails unless every request completes its budget
    and every decode step went through the path's decode kernel (K6/K7, or
    K8/K9 when paged) once per layer, and never through the other one.
    The result's ``tokens`` holds each request's output."""
    tfm, attn = port["tfm"], port["attn"]
    cfg, dev = port["cfg"], port["dev"]
    params = tfm.init(0, cfg, device=dev, dtype=torch.bfloat16)
    opts = dict(slots=8, max_len=2048, temperature=0.0, dtype=torch.bfloat16,
                prompt_buckets=(128, 512), steps_per_sync=16, device=dev)
    opts.update(batcher_kw)

    def batcher():
        return port["serve"].ContinuousBatcher(params, cfg, **opts)

    warm = batcher()  # one-time costs (cuBLAS handles, allocator) out
    warm.run(prompts[:2], max_new=4)
    del warm
    kern, other = attn.decode_attention, attn.decode_attention_paged
    if opts.get("paged"):
        kern, other = other, kern
    cb = batcher()
    rids = [cb.submit(p, max_new=m) for p, m in zip(prompts, max_new)]
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    kern.launches = other.launches = 0
    t0 = time.perf_counter()
    while cb.pending():
        cb.step()
    sync(torch)
    wall = time.perf_counter() - t0
    launches, other_launches = kern.launches, other.launches
    st = dict(cb.stats)  # before the windows below add to them
    utilization = cb.utilization()
    peak_mem_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = [cb.result(rid) for rid in rids]
    for rid, out, p, m in zip(rids, tokens, prompts, max_new):
        if len(out) != len(p) + m or not (out >= 0).all() \
                or not (out < cfg.vocab_size).all():
            fail(f"{label}: request {rid} did not complete its budget "
                 f"({len(out) - len(p)} of {m})")
    if launches != cfg.n_layers * st["decode_steps"] or other_launches:
        fail(f"{label}: {launches} launches of {kern.__name__} and "
             f"{other_launches} of {other.__name__} for "
             f"{st['decode_steps']} decode steps x {cfg.n_layers} layers")
    ts = cb.timing_stats()
    lat = cb.latency_stats()
    res = {"label": label, "requests": len(prompts),
           "emitted_tokens": st["emitted_tokens"],
           "decode_steps": st["decode_steps"], "launches": launches,
           "kernel": kern.__name__,
           "wall_s": wall, "tokens_per_s": st["emitted_tokens"] / wall,
           "ms_per_decode_step": (ts["dispatch"]["total_s"]
                                  / st["decode_steps"] * 1e3
                                  if st["decode_steps"] else None),
           "ms_per_prefill": (ts["prefill"]["total_s"]
                              / st["prefill_dispatches"] * 1e3
                              if st["prefill_dispatches"] else None),
           "prefill_dispatches": st["prefill_dispatches"],
           "utilization": utilization,
           "emitted_per_slot_step": cb.emitted_per_slot_step(),
           "ttft_p50_s": lat["ttft_p50"], "ttft_p95_s": lat["ttft_p95"],
           "peak_mem_gb": peak_mem_gb,
           "timing_total_s": {k: v["total_s"] for k, v in ts.items()
                              if k != "_total_s"}}
    for k in ("decode_dispatches", "slot_steps", "batch_admissions",
              "inblock_prefill_steps", "inblock_refills",
              "chained_dispatches", "evictions", "swap_ins",
              "compact_dispatches", "spec_rounds", "spec_proposed",
              "spec_accepted", "prefix_hits", "prefix_pages_shared",
              "prefix_reclaimed"):
        res[k] = st[k]
    if opts.get("paged"):
        res["pool_pages"] = cb.pool_pages
        res["pool_gb"] = sum(t.numel() * t.element_size()
                             for lyr in cb.cache.values()
                             for t in lyr.values()) / 1e9
    if window_blocks:
        # the device's idle share, within one window: decode blocks over a
        # full pool, run unprofiled (wall), profiled (device time by
        # kernel), unprofiled again.  These launches come after the count.
        win = [prompts[:8], window_blocks]
        unprof = [decode_window(torch, cb, *win, profiled=False,
                                max_new=window_new)]
        prof = decode_window(torch, cb, *win, profiled=True,
                             max_new=window_new)
        unprof.append(decode_window(torch, cb, *win, profiled=False,
                                    max_new=window_new))
        prof["unprofiled_wall_ms_per_decode_step"] = [
            w["wall_ms_per_decode_step"] for w in unprof]
        prof["device_idle_share"] = 1.0 - prof["device_ms_per_decode_step"] \
            / float(np.mean(prof["unprofiled_wall_ms_per_decode_step"]))
        res["profile"] = prof
    print(f"  {label}: " + json.dumps(res))
    res["tokens"] = tokens
    del params, cb
    torch.cuda.empty_cache()
    return res


# -- phases 6-8: the LM-training slice -------------------------------------

# Flash kernels (K2 forward, K3 dQ, K4 dK/dV) against their plain versions.
# float32: both sides compute in f32 and differ in summation order: o and
# lse to 2e-5, gradients to 1e-4, each absolute plus relative (the JAX
# tests' own tolerances).  bfloat16: both sides round p (and ds) to bf16
# at different points, and each rounds its f32 sums to the bf16 output
# independently, which alone can differ by one bf16 ulp (<= 2^-7 |x|).  So
# o is held to min(1e-2, 5% of its row's RMS) plus one ulp of the element,
# lse (f32 on both sides) to 1e-3, and each gradient to 5% of the
# reference's RMS over its (b*h) slab plus one ulp of the element.
FLASH_TOL = {"float32": {"o": (2e-5, 2e-5), "lse": (2e-5, 2e-5),
                         "grad": (1e-4, 1e-4)},
             "bfloat16": {"o_abs": 1e-2, "o_row_rms": 5e-2, "lse": 1e-3,
                          "grad_slab_rms": 5e-2, "ulp": 2.0 ** -7}}
FLASH_KERNELS = ("K2", "K3", "K4")
FLASH_EDGE_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 1000, 2048)


def ptxas_report(log: str, kernel: str) -> list[dict]:
    """What ``nvcc -Xptxas -v`` says of each compiled entry whose name holds
    ``kernel``: registers, spill stores and loads (bytes), stack frame and
    static shared memory (bytes), and the template's first integer (the
    head dim of the flash kernels)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)} if kernel in m.group(1) else None
            if cur is not None:
                t = re.search(r"ILi(\d+)E", m.group(1))
                cur["template_int"] = int(t.group(1)) if t else None
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def flash_agreement(torch, name, got, ref, dtype: str) -> float:
    """Worst error/tolerance of ``got`` against ``ref`` (``name`` "o",
    "lse" or "grad"; tensors (BH, S[, D]); ``dtype`` the operands')."""
    err = (got.float() - ref.float()).abs()
    r = ref.float()
    tol = FLASH_TOL[dtype]
    if dtype == "float32":
        atol, rtol = tol[name]
        bound = atol + rtol * r.abs()
    elif name == "lse":
        bound = torch.full_like(r, tol["lse"])
    elif name == "o":
        rms = r.pow(2).mean(-1, keepdim=True).sqrt()
        bound = torch.minimum(torch.full_like(rms, tol["o_abs"]),
                              tol["o_row_rms"] * rms) + tol["ulp"] * r.abs()
    else:
        rms = r.pow(2).mean(dim=(-2, -1), keepdim=True).sqrt()
        bound = tol["grad_slab_rms"] * rms + tol["ulp"] * r.abs()
    ratio = (err / bound.clamp_min(1e-12)).max().item()
    if not bool(torch.isfinite(got).all()):
        ratio = math.inf
    return ratio


def flash_case(torch, attn, *, bh, s, d, dtype, causal, dlse, seed,
               sk=None):
    """One case: K2, K3 and K4 on (bh, s, d) queries and (bh, sk, d) keys
    (sk = s unless given) against the plain versions, each kernel run twice
    (bitwise equal or it fails); returns {kernel: (max abs err, worst
    err/tol)}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sk = s if sk is None else sk

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, do = randn(bh, s, d), randn(bh, s, d)
    k, v = randn(bh, sk, d), randn(bh, sk, d)
    o, lse = attn.flash_attention_fwd(q, k, v, causal=causal)
    o2, lse2 = attn.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = attn.flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        fail(f"K2: two runs differ (bh={bh} s={s} sk={sk} d={d} "
             f"causal={causal} {dtype})")
    delta = (do.float() * ro.float()).sum(-1)
    if dlse:  # the (o, lse) form with a nonzero lse cotangent
        delta = delta - torch.randn((bh, s), generator=gen, device="cuda")
    dq, dq2 = (attn.flash_attention_bwd_dq(q, k, v, rlse, do, delta,
                                           causal=causal) for _ in range(2))
    (dk, dv), (dk2, dv2) = (attn.flash_attention_bwd_dkv(
        q, k, v, rlse, do, delta, causal=causal) for _ in range(2))
    rdq, rdk, rdv = attn.flash_attention_bwd_plain(q, k, v, rlse, do, delta,
                                                   causal=causal)
    torch.cuda.synchronize()
    for name, a, b in (("K3", (dq,), (dq2,)), ("K4", (dk, dv), (dk2, dv2))):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"{name}: two runs differ (bh={bh} s={s} sk={sk} d={d} "
                 f"causal={causal} {dtype})")
    out = {}
    for kname, pairs in (("K2", (("o", o, ro), ("lse", lse, rlse))),
                         ("K3", (("grad", dq, rdq),)),
                         ("K4", (("grad", dk, rdk), ("grad", dv, rdv)))):
        err = max((g.float() - r.float()).abs().max().item()
                  for _, g, r in pairs)
        ratio = max(flash_agreement(torch, n, g, r, str(dtype)[6:])
                    for n, g, r in pairs)
        out[kname] = (err, ratio)
    return out


def check_flash(torch, attn) -> dict:
    """Every case of K2-K4 against the plain versions on the card; returns
    the worst error and error/tolerance per kernel."""
    worst = {k: [0.0, 0.0] for k in FLASH_KERNELS}
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            for causal in (False, True):
                for s in (256, 1024):
                    cases.append(dict(bh=8, s=s, d=d, dtype=dtype,
                                      causal=causal, dlse=False))
        # a ragged length (not a multiple of any tile) and the lse cotangent
        cases.append(dict(bh=8, s=200, d=128, dtype=dtype, causal=True,
                          dlse=False))
        cases.append(dict(bh=8, s=256, d=64, dtype=dtype, causal=True,
                          dlse=True))
    # the training shape: B=8 x H=8, S=1024, D=128, causal, bf16
    cases.append(dict(bh=64, s=1024, d=128, dtype=torch.bfloat16,
                      causal=True, dlse=False))
    # the bf16 forward's tile edges (128-row query and key tiles, 64-row
    # warpgroup halves): one (b, h) up to 129 rows, 64 of them at S = 1000,
    # 8 at S = 2048; and non-causal queries over a longer key sequence.  At
    # S = 1 the softmax has one key, so dq and dk vanish identically but
    # for an lse cotangent: those cases carry one, or K3 and K4 would be
    # held to a tolerance scaled by a zero gradient.
    for s in FLASH_EDGE_LENGTHS:
        for d in (64, 128):
            for causal in (False, True):
                cases.append(dict(bh=1 if s <= 129 else 64 if s == 1000
                                  else 8, s=s, d=d, dtype=torch.bfloat16,
                                  causal=causal, dlse=s == 1))
        if s == 1000:
            for d in (64, 128):
                cases.append(dict(bh=8, s=256, sk=1000, d=d,
                                  dtype=torch.bfloat16, causal=False,
                                  dlse=False))
    for i, case in enumerate(cases):
        res = flash_case(torch, attn, seed=100 + i, **case)
        for k, (err, ratio) in res.items():
            worst[k][0] = max(worst[k][0], err)
            worst[k][1] = max(worst[k][1], ratio)
        print(f"  {str(case['dtype'])[6:]:8s} BH={case['bh']:2d} "
              f"S={case['s']:4d}x{case.get('sk', case['s']):4d} "
              f"D={case['d']:3d} causal={case['causal']:d} "
              f"dlse={case['dlse']:d}: " + ", ".join(
                  f"{k} err {e:.2e} ({r:.3f} of tol)"
                  for k, (e, r) in res.items()))
        bad = [k for k, (_, r) in res.items() if not r <= 1.0]
        if bad:
            fail(f"{bad} disagree with their plain versions in case {case}")
    print(f"  K2/K3/K4 agree with their plain versions in all "
          f"{len(cases)} cases; each bitwise equal to itself in each")
    return {k: {"max_abs_err": e, "err_over_tol": r}
            for k, (e, r) in worst.items()}


def time_flash(torch, F, attn, facts, bwd_only: bool = False) -> dict:
    """K2, K3 and K4 at the training shape (B=8, H=8, S=1024, D=128,
    causal, bf16): device ms by CUDA events, the bound (the causal work's
    matrix-product FLOPs over the bf16 peak, or the bytes each input read
    once and each output written once over the memory rate, whichever is
    larger), the plain version's time and a library yardstick (SDPA, which
    the port never calls).  K2 and SDPA's forward are timed in alternated
    windows; so are K3, K4, K3 + K4 and the port's whole backward (delta
    = rowsum(do * o), then K3 and K4, as ``_FlashAttention.backward`` runs
    it) against SDPA's autograd backward (dq, dk and dv together, its own
    delta pass included).  A share of the bound is bound / ms.  Each
    operand is 16 MB, so one call's inputs already exceed the 50 MB L2.
    ``bwd_only`` skips K2's windows and the plain versions."""
    b, h, s, d = 8, 8, 1024, 128
    bh, dt = b * h, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda")
                   .to(dt) for _ in range(4))
    o, lse = attn.flash_attention_fwd(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    launches0 = [getattr(attn, f).launches for f in
                 ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")]

    def run_k3():
        return attn.flash_attention_bwd_dq(q, k, v, lse, do, delta,
                                           causal=True)

    def run_k4():
        return attn.flash_attention_bwd_dkv(q, k, v, lse, do, delta,
                                            causal=True)

    def run_k34():
        run_k3()
        run_k4()

    def full():  # the port's backward: delta, then K3 and K4
        dl = (do.float() * o.float()).sum(-1)
        attn.flash_attention_bwd_dq(q, k, v, lse, do, dl, causal=True)
        attn.flash_attention_bwd_dkv(q, k, v, lse, do, dl, causal=True)

    # library yardsticks: SDPA forward; SDPA's autograd backward (dq, dk
    # and dv together) for K3, K4 and both
    q4, k4, v4 = (t.view(b, h, s, d).clone().requires_grad_(True)
                  for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    o4 = sdpa()
    do4 = do.view(b, h, s, d)

    def sdpa_bwd():
        return torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)

    # only readings taken in turns compare: K2 against SDPA's forward (K2,
    # SDPA, SDPA, K2, twice); the backward kernels against SDPA's backward
    # in a palindrome, twice
    windows = {n: [] for n in ("K2", "SDPA", "K3", "K4", "K3+K4", "full",
                               "SDPA bwd")}
    fns = {"K2": lambda: attn.flash_attention_fwd(q, k, v, causal=True),
           "SDPA": sdpa, "K3": run_k3, "K4": run_k4, "K3+K4": run_k34,
           "full": full, "SDPA bwd": sdpa_bwd}
    order = () if bwd_only else ("K2", "SDPA", "SDPA", "K2") * 2
    order += ("K3", "K4", "SDPA bwd", "K3+K4", "full", "full", "K3+K4",
              "SDPA bwd", "K4", "K3") * 2
    for name in order:
        windows[name].append(time_ms(torch, fns[name], iters=50))
    ms = {n: float(np.mean(w)) for n, w in windows.items() if w}
    for f, n0 in zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv"), launches0):
        getattr(attn, f).launches = n0  # timing launches are not counted
    plain_fwd = plain_bwd = None
    if not bwd_only:
        plain_fwd = time_ms(torch, lambda: attn.flash_attention_fwd_plain(
            q, k, v, causal=True), iters=5)
        plain_bwd = time_ms(torch, lambda: attn.flash_attention_bwd_plain(
            q, k, v, lse, do, delta, causal=True), iters=5)
    lib_bwd = ms["SDPA bwd"]
    pairs = bh * s * (s + 1) // 2  # live (query, key) pairs, causal
    t_bytes = 2 * bh * s * d       # one bf16 (BH, S, D) operand
    ops = {"K2": 4 * pairs * d, "K3": 6 * pairs * d, "K4": 8 * pairs * d}
    nbytes = {"K2": 4 * t_bytes + 4 * bh * s,
              "K3": 5 * t_bytes + 8 * bh * s,
              "K4": 6 * t_bytes + 8 * bh * s}
    out = {}
    for n in FLASH_KERNELS:
        if n not in ms:
            continue
        tb = nbytes[n] / facts["bw"] * 1e3
        to = ops[n] / PEAK_OPS["bfloat16"] * 1e3
        out[n] = {"ms": ms[n], "ms_windows": windows[n],
                  "plain_ms": plain_fwd if n == "K2" else plain_bwd,
                  "library_ms": ms["SDPA"] if n == "K2" else lib_bwd,
                  "library": ("F.scaled_dot_product_attention forward"
                              if n == "K2" else
                              "SDPA autograd backward, dq+dk+dv together"),
                  "plain": ("flash_attention_fwd_plain" if n == "K2" else
                            "flash_attention_bwd_plain, dq+dk+dv together"),
                  "bound_ms": max(tb, to),
                  "bound_by": "bytes" if tb >= to else "operations",
                  "flops": ops[n], "bytes": nbytes[n],
                  "tflops_per_s": ops[n] / ms[n] / 1e9,
                  "bound_share": max(tb, to) / ms[n]}
    if "K2" in out:
        out["K2"].update(
            library_ms_windows=windows["SDPA"],
            over_library=[a / b for a, b in zip(windows["K2"],
                                                windows["SDPA"])])
        out["K2"]["over_library_mean"] = ms["K2"] / ms["SDPA"]
    # K3 + K4 and the whole backward against SDPA's backward: SDPA's five
    # products, 2 (forward S recomputed) + 8 (dq, dk, dv, dp) pairs.d flops
    bound = out["K3"]["bound_ms"] + out["K4"]["bound_ms"]
    for n in ("K3+K4", "full"):
        out[n] = {"ms": ms[n], "ms_windows": windows[n],
                  "library_ms": lib_bwd, "library_ms_windows":
                  windows["SDPA bwd"], "over_library": ms[n] / lib_bwd,
                  "tflops_per_s": (ops["K3"] + ops["K4"]) / ms[n] / 1e9,
                  "bound_ms": bound, "bound_share": bound / ms[n]}
    out["SDPA bwd"] = {"ms": lib_bwd, "tflops_per_s": 10 * pairs * d
                       / lib_bwd / 1e9}
    return out


def lm_cfg_flops(cfg, n_params: int, b: int, s: int) -> float:
    """Model FLOPs of one training step (forward + backward): 6 N T for
    the dense products (N = every parameter, the tied embedding counted
    once for the head) plus 6 L H Dh S T for causal attention (half of the
    12 L H Dh S T of full attention), T = B S tokens."""
    t = b * s
    return 6.0 * n_params * t + 6.0 * cfg.n_layers * cfg.n_heads \
        * cfg.head_dim * s * t


def train_step_check(torch, port, label: str = "f32 step",
                     **model_kw) -> dict:
    """One LM-base-width train step in float32 (2 layers, B=2, S=512,
    ``model_kw`` on top: an MoE layer 1 with ``n_experts``) through the
    flash kernels against the same step through reference attention, from
    the same params and batch."""
    import dataclasses
    tfm, lm = port["tfm"], port["lm"]
    model = dataclasses.replace(tfm.PRESETS["LM-base"], n_layers=2,
                                **model_kw)
    cfg = lm.LMTrainConfig(model=model, compute_dtype=None)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, model.vocab_size, (2, 512)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1).astype(np.int32)
    targets[:, -1] = lm.IGNORE
    runs = {}
    for impl in ("flash", "reference"):
        tr = lm.LMTrainer(cfg, device=DEVICE, attn_impl=impl)
        if impl == "reference":
            tr.load_state({n: p.detach() for n, p in
                           runs["flash"]["init"].items()})
        init = {n: p.detach().clone() for n, p in tr.params.items()}
        loss = float(tr.train_step(tokens, targets))
        runs[impl] = {"init": init, "loss": loss, "trainer": tr,
                      "gnorm": float(tr.last_metrics[0])}
    fl, rf = runs["flash"], runs["reference"]
    rel = abs(fl["loss"] - rf["loss"]) / abs(rf["loss"])
    grel = abs(fl["gnorm"] - rf["gnorm"]) / rf["gnorm"]
    # Post-step params: Adam's first step moves each entry by about
    # lr * g / (|g| + eps), so float32 summation-order noise in g can move
    # an entry with |g| near eps by up to 2 lr; elsewhere the two steps
    # agree to float32 noise.  Held: every entry within 2 lr, and at most
    # 0.1% of the entries more than 1e-6 apart.
    max_d, n_far, n_all = 0.0, 0, 0
    for n, p in fl["trainer"].params.items():
        diff = (p.detach() - rf["trainer"].params[n].detach()).abs()
        max_d = max(max_d, diff.max().item())
        n_far += int((diff > 1e-6).sum())
        n_all += diff.numel()
    res = {"loss_flash": fl["loss"], "loss_reference": rf["loss"],
           "loss_rel_diff": rel, "grad_norm_rel_diff": grel,
           "param_max_abs_diff": max_d, "param_frac_over_1e-6":
           n_far / n_all, "lr": cfg.lr}
    print(f"  {label}, flash vs reference: " + json.dumps(res))
    if not rel <= 1e-5 or not grel <= 1e-5:
        fail(f"flash and reference train steps disagree: loss rel {rel}, "
             f"grad-norm rel {grel}")
    if not (max_d <= 2 * cfg.lr and n_far / n_all <= 1e-3):
        fail(f"post-step params disagree: max {max_d}, "
             f"{n_far}/{n_all} entries over 1e-6")
    del runs
    torch.cuda.empty_cache()
    return res


def active_params(cfg, n_params: int) -> int:
    """Parameters a token meets: all of them, less the experts it is not
    routed to (E - top_k of the E in each MoE layer)."""
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    idle = cfg.n_experts - cfg.moe_top_k if cfg.n_experts else 0
    return n_params - n_moe * idle * 3 * cfg.d_model * cfg.ff


def training_run(torch, port, steps: int = 30, extra=(),
                 label: str = "LM-base bf16 training",
                 inspect=None) -> dict:
    """LM-base (24 layers, d_model 1024, byte vocab) through lm_cli, B=8,
    S=1024, bf16 compute, synthetic corpus, with the flags ``extra``.  The
    host waits for the device only at the ends of the windows (and where
    lm_cli logs): steps 2-10 and 16-30 are timed unprofiled, steps 11-15
    run under torch.profiler for device time, a step mark between two of
    them (``profiled_steps``: device operations step by step).  The flash
    (K2-K4) and int8
    matmul (K5) launch counts are set to 0 before the run and read after
    it: flash once per layer per step; K5 7 times per layer per step with
    ``--matmul-dtype int8``, every one through its sm90 route, and never
    without it.  mfu counts the active parameters (``active_params``).
    ``inspect(trainer)``, when given, adds its dict to the result before
    the trainer is freed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    attn, cli, qz = port["attn"], port["lm_cli"], port["qz"]
    b, s = 8, 1024
    argv = ["--preset", "LM-base", "--steps", str(steps), "--batch-size",
            str(b), "--seq-len", str(s), "--compute-dtype", "bfloat16",
            "--log-every", "10", "--device", DEVICE, *extra]
    prof = None
    marks = (1, 10, 15, steps)  # windows (1, 10] and (15, steps] unprofiled
    losses, t = [], {}

    def on_step(step, trainer, loss):
        nonlocal prof
        losses.append(loss)
        if marks[1] < step < marks[2]:
            mark_step(torch)
        if step in marks:
            torch.cuda.synchronize()
            if step == marks[2]:  # every record in (stop_profile)
                port["tracing"].stop_profile(prof)
            t[step] = time.perf_counter()
            if step == marks[1]:  # a warm-up cycle first (start_profile)
                prof = port["tracing"].start_profile(
                    [ProfilerActivity.CUDA])

    for f in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        getattr(attn, f).launches = 0
    qz.int8_matmul_q.launches = 0
    qz.int8_matmul_q.route_launches = dict.fromkeys(qz.ROUTES, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = cli.run(argv, on_step=on_step)
    launches = {"K2": attn.flash_attention_fwd.launches,
                "K3": attn.flash_attention_bwd_dq.launches,
                "K4": attn.flash_attention_bwd_dkv.launches,
                "K5": qz.int8_matmul_q.launches}
    k5_routes_run = dict(qz.int8_matmul_q.route_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = trainer.cfg.model
    n_params = sum(p.numel() for p in trainer.params.values())
    n_active = active_params(cfg, n_params)
    losses = [float(x) for x in losses]
    for i in [0] + list(range(9, steps, 10)):
        print(f"  step {i + 1}: loss {losses[i]:.4f}")
    windows = [(t[marks[1]] - t[marks[0]]) / (marks[1] - marks[0]),
               (t[marks[3]] - t[marks[2]]) / (marks[3] - marks[2])]
    step_ms = (t[marks[1]] - t[marks[0]] + t[marks[3]] - t[marks[2]]) \
        / (marks[1] - marks[0] + marks[3] - marks[2]) * 1e3
    device_us, n_ops, top, counts = 0.0, 0, {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and STEP_MARK not in e.key:
            device_us += e.self_device_time_total
            n_ops += e.count
            top[e.key] = top.get(e.key, 0.0) + e.self_device_time_total
            counts[e.key] = counts.get(e.key, 0) + e.count
    n_prof = marks[2] - marks[1]
    by_step = profiled_steps(prof)
    device_ms = device_us / 1e3 / n_prof
    flops = lm_cfg_flops(cfg, n_active, b, s)
    res = {"flags": list(extra), "steps": steps, "batch": b, "seq": s,
           "n_params": n_params, "n_active_params": n_active,
           "losses_every_10": [losses[0]] + losses[9::10],
           "losses": losses,
           "ms_per_step": step_ms,
           "ms_per_step_windows": [w * 1e3 for w in windows],
           "tokens_per_s": b * s / (step_ms / 1e3),
           "first_step_s": t[1] - t0,  # with model and corpus setup
           "peak_mem_gb": peak_gb, "launches": launches,
           "k5_route_launches": k5_routes_run,
           "k5_device_ops_per_step": {
               k[:60]: c / n_prof for k, c in counts.items()
               if "int8_matmul" in k},
           "device_ms_per_step": device_ms,
           "device_ops_per_step": n_ops / n_prof,
           "device_ops_by_step": by_step["ops_by_step"],
           "device_ops_step": by_step["ops_step"],
           "device_idle_share": 1.0 - device_ms / step_ms,
           "flash_share_of_device_time": {
               n: sum(us for k, us in top.items() if fn in k)
               / max(device_us, 1e-9) for n, fn in SM90_KERNELS.items()},
           "model_tflop_per_step": flops / 1e12,
           "mfu": flops / (step_ms / 1e3) / PEAK_OPS["bfloat16"],
           "top_kernels": [[k[:60], us / max(device_us, 1e-9)] for k, us in
                           sorted(top.items(), key=lambda kv: -kv[1])[:10]]}
    if inspect is not None:
        res.update(inspect(trainer))
    print(f"  {label}: " + json.dumps(res))
    if not all(np.isfinite(losses)) or len(losses) != steps:
        fail(f"training losses malformed: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5:
        fail(f"the loss did not fall over {steps} steps: {losses}")
    per_step = {"K2": 1, "K3": 1, "K4": 1,
                "K5": 7 if "--matmul-dtype" in extra else 0}
    for k, n in launches.items():
        if n != per_step[k] * cfg.n_layers * steps:
            fail(f"{k}: {n} launches for {steps} steps x {cfg.n_layers} "
                 f"layers, want {per_step[k]} per layer per step")
    if k5_routes_run["sm90"] != launches["K5"]:
        fail(f"K5: {k5_routes_run} launches by route, want all "
             f"{launches['K5']} through sm90")
    del trainer
    torch.cuda.empty_cache()
    return res


# -- phases 9-11: the paged-serving slice ----------------------------------

PAGE = 512  # the batcher's page size


def make_paged(torch, case, seed: int, page: int = PAGE) -> dict:
    """A dense case's caches (``make_case``) scattered page by page into a
    shuffled pool of B * n_pages + 3 pages.  Pages 0-2 belong to no
    sequence and hold garbage (+-1e4 once dequantized), as do the rows past
    each sequence's pos in its last live page; the table entries past
    pos // page hold an index far outside the pool."""
    b, hkv, s, d = case["k"].shape
    n_pages = s // page
    pids = torch.from_numpy(np.random.default_rng(seed).permutation(
        b * n_pages) + 3).to(case["k"].device)
    table = pids.reshape(b, n_pages).to(torch.int32)
    pos = [int(p) for p in case["pos"].tolist()]
    out = {"q": case["q"], "pos": case["pos"], "live_table": table}
    for name, fill in (("k", 1e4), ("v", -1e4), ("k_scale", 100.0),
                       ("v_scale", 100.0)):
        x = case[name]
        if x is None:
            out[name] = None
            continue
        w = x.shape[-1]
        if x.dtype == torch.int8:
            fill = 100 if fill > 0 else -100
        pool = torch.full((b * n_pages + 3, hkv, page, w), fill,
                          dtype=x.dtype, device=x.device)
        pool[pids] = (x.reshape(b, hkv, n_pages, page, w).transpose(1, 2)
                      .reshape(b * n_pages, hkv, page, w))
        for j, p in enumerate(pos):
            pool[int(table[j, p // page]), :, p % page + 1:] = fill
        out[name] = pool
    poisoned = table.clone()
    for j, p in enumerate(pos):
        poisoned[j, p // page + 1:] = 2 ** 30
    out["table"] = poisoned
    return out


def run_paged(attn, pc, plain: bool = False):
    fn = attn.decode_attention_paged_plain if plain \
        else attn.decode_attention_paged
    return fn(pc["q"], pc["k"], pc["v"], pc["table"], pc["pos"],
              k_scale=pc["k_scale"], v_scale=pc["v_scale"])


def check_paged_kernels(torch, attn) -> dict:
    """K8/K9 against ``decode_attention_paged_plain`` in every case, bitwise
    against K6/K7 (``decode_attention``) over the same rows laid out
    contiguously, and each launch repeated (``repeat_bitwise``); returns
    the worst error and error/tolerance per kernel."""
    worst = {"K8": 0.0, "K9": 0.0}
    worst_ratio = {"K8": 0.0, "K9": 0.0}
    cases = []
    for quant in (False, True):
        for qdtype in (torch.float32, torch.bfloat16):
            for d in (128, 64):
                for g in (1, 4):
                    cases.append(dict(b=5, h=4 * g, hkv=4, s=2048, d=d,
                                      qdtype=qdtype, quant=quant))
        # the serving shape: 8 slots x 8 heads x 128, 4 pages per sequence
        cases.append(dict(b=8, h=8, hkv=8, s=2048, d=128,
                          qdtype=torch.bfloat16, quant=quant))
    # 0, a tile edge, the last row of page 0, the first of page 1, S-1, and
    # deep ragged depths; then phase 3's split edges
    cases = [(sh, ([0, 31, 511, 512, sh["s"] - 1]
                   + [700 + 97 * j for j in range(sh["b"])])[:sh["b"]])
             for sh in cases] + split_cases(torch)
    for i, (sh, pos) in enumerate(cases):
        s, b = sh["s"], sh["b"]
        case = make_case(torch, pos=pos, seed=300 + i, **sh)
        pc = make_paged(torch, case, seed=i)
        out, ref = run_paged(attn, pc), run_paged(attn, pc, plain=True)
        dense, _ = run_case(attn, case)
        sync(torch)
        err, ratio = agreement(torch, out, ref)
        name, twin = ("K9", "K7") if sh["quant"] else ("K8", "K6")
        worst[name] = max(worst[name], err)
        worst_ratio[name] = max(worst_ratio[name], ratio)
        print(f"  {name} {str(sh['qdtype'])[6:]:8s} D={sh['d']:3d} "
              f"g={sh['h'] // sh['hkv']:2d} B={b} S={s} pos={pos}: "
              f"max_abs_err {err:.3e}, err/tol {ratio:.3f}")
        if not ratio <= 1.0:
            fail(f"{name} disagrees with decode_attention_paged_plain: "
                 f"{err} ({ratio} x the tolerance)")
        if not torch.equal(out, dense):
            fail(f"{name} is not bitwise equal to {twin} over the same rows "
                 f"laid out contiguously (case {i})")
        repeat_bitwise(torch, lambda: run_paged(attn, pc), out,
                       f"{name} case {i}")
    print(f"  K8/K9: all {len(cases)} cases within tolerance of the plain "
          f"version, bitwise equal to K6/K7 on the same rows and to "
          f"themselves over 52 launches, with poisoned table tails and "
          f"garbage in unowned pages and rows")
    return {"max_abs_err": worst, "err_over_tol": worst_ratio}


def time_paged_kernel(torch, F, attn, *, quant: bool, facts) -> dict:
    """K8 (bf16 pool) or K9 (int8 pool) at the serving shape: 8 slots x 8
    kv heads x 128, 4 pages of 512 per sequence, phase 3's ragged depths,
    pools rotated over enough copies to exceed the 50 MB L2.  Beside it the
    plain version, and SDPA over the contiguous view gathered from the
    pool through the table (the gather excluded from its time; a yardstick
    the port never calls), timed in alternated windows with the kernel."""
    b, h, hkv, s, d = 8, 8, 8, 2048, 128
    qdtype = torch.bfloat16
    rng = np.random.default_rng(7)
    pos = [int(p) for p in rng.integers(64, 1985, b)]  # phase 3's depths
    base = make_case(torch, b=b, h=h, hkv=hkv, s=s, d=d, qdtype=qdtype,
                     quant=quant, pos=pos, seed=99)
    pc = make_paged(torch, base, seed=99)
    out, ref = run_paged(attn, pc), run_paged(attn, pc, plain=True)
    err, ratio = agreement(torch, out, ref)
    if not ratio <= 1.0 or not torch.equal(out, run_case(attn, base)[0]):
        fail(f"decode_attention_paged on the timed case: err {err} "
             f"({ratio} x the tolerance), or not bitwise the dense kernel")
    per = sum(pc[k].numel() * pc[k].element_size()
              for k in ("k", "v", "k_scale", "v_scale") if pc[k] is not None)
    n_rot = max(2, math.ceil(200e6 / per))
    cases = [pc] + [{key: (t.clone() if torch.is_tensor(t) else t)
                     for key, t in pc.items()} for _ in range(n_rot - 1)]
    it = iter(range(10 ** 9))

    def kernel():
        run_paged(attn, cases[next(it) % n_rot])

    def plain():
        run_paged(attn, cases[next(it) % n_rot], plain=True)

    slot = torch.arange(s, device="cuda")
    mask = (slot[None, :] <= base["pos"][:, None].long())[:, None, None, :]
    dense = []
    for c in cases:
        view = []
        for name in ("k", "v", "k_scale", "v_scale"):
            x = c[name]
            if x is not None:
                x = (x[c["live_table"].long()].transpose(1, 2)
                     .reshape(b, hkv, s, x.shape[-1]))
            view.append(x)
        kd, vd, ks, vs = view
        if quant:
            kd, vd = (kd.float() * ks).to(qdtype), (vd.float() * vs).to(qdtype)
        dense.append((c["q"], kd.contiguous(), vd.contiguous()))

    def library():
        qq, kd, vd = dense[next(it) % n_rot]
        F.scaled_dot_product_attention(qq, kd, vd, attn_mask=mask)

    launches0 = attn.decode_attention_paged.launches
    res = alternated(torch, kernel, library)
    wrapper_us = host_us(torch, kernel)
    attn.decode_attention_paged.launches = launches0  # not counted
    plain_ms = time_ms(torch, plain, iters=10)
    rows = sum(p + 1 for p in pos) * hkv
    itemsize = 1 if quant else 2
    # K6/K7's bytes plus the table entries the live tiles read (one int32
    # per live page per sequence)
    nbytes = (rows * d * 2 * itemsize + (rows * 8 if quant else 0)
              + 2 * b * h * d * 2 + 4 * b
              + 4 * sum(p // PAGE + 1 for p in pos))
    ops = 4 * d * sum(p + 1 for p in pos) * h
    t_bytes = nbytes / facts["bw"] * 1e3
    t_ops = ops / PEAK_OPS["bfloat16"] * 1e3
    bound = max(t_bytes, t_ops)
    split_len, n_splits = attn.decode_split_plan(b, hkv, h // hkv, s)[:2]
    res.update({"plain_ms": plain_ms,
                "library": "F.scaled_dot_product_attention over the "
                           "contiguous view gathered through the table "
                           "(gather excluded)",
                "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_share": bound / res["ms"], "bytes": nbytes,
                "host_us_per_call": wrapper_us, "pos": pos,
                "split_len": split_len, "n_splits": n_splits,
                "max_abs_err": err, "err_over_tol": ratio})
    return res


def paged_exactness(torch, port) -> dict:
    """LM-base in float32 through the paged batcher: (1) two requests that
    both cross page 0's boundary on a 2-page pool (one is evicted and
    swapped back in), (2) shared-prefix admissions over a 520-token
    common prompt and (3) in-block refill handoffs (rows switching table
    rows mid-block), each against static generate() per request (flips
    only at near-ties), (3) also against the same run through K8's plain
    version (tokens equal); (4) one decode step's logits through K8
    against the plain paged path, on a prefilled cache scattered into a
    shuffled pool."""
    tfm, gen, attn, serve = port["tfm"], port["gen"], port["attn"], \
        port["serve"]
    cfg, dev = port["cfg"], port["dev"]
    params = tfm.init(0, cfg, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(2)
    v = cfg.vocab_size
    res = {}
    prompts = [rng.integers(0, v, (n,)).astype(np.int32) for n in (470, 490)]
    cb = serve.ContinuousBatcher(
        params, cfg, slots=2, max_len=1024, temperature=0.0,
        prompt_buckets=(512,), paged=True, pool_pages=3, steps_per_sync=8,
        device=dev)
    got = cb.run(prompts, max_new=48)
    st = cb.stats
    res["oversubscribed"] = {
        "evictions": st["evictions"], "swap_ins": st["swap_ins"],
        "flips": check_greedy(torch, port, params, prompts, got, 48,
                              "oversubscribed pool")}
    if not (st["evictions"] >= 1 and st["swap_ins"] == st["evictions"]):
        fail(f"the oversubscribed pool did not preempt and resume: {st}")
    sysp = rng.integers(0, v, (520,)).astype(np.int32)
    prompts = [np.concatenate([sysp, rng.integers(0, v, (n,)).astype(
        np.int32)]) for n in (12, 30, 7)]
    cb = serve.ContinuousBatcher(
        params, cfg, slots=2, max_len=1024, temperature=0.0,
        prompt_buckets=(64, 1024), paged=True, prefix_cache=True,
        steps_per_sync=8, device=dev)
    got = cb.run(prompts, max_new=16)
    res["prefix"] = {
        "prefix_hits": cb.stats["prefix_hits"],
        "prefix_pages_shared": cb.stats["prefix_pages_shared"],
        "flips": check_greedy(torch, port, params, prompts, got, 16,
                              "shared prefix")}
    if cb.stats["prefix_hits"] < 1:
        fail(f"no shared-prefix admission: {cb.stats}")
    # (3) in-block refill handoffs on the pool: ragged budgets through two
    # slots, so rows switch to a staged refill's table row mid-block on
    # the device; against generate() and against the same run through
    # K8's plain version
    prompts = [rng.integers(0, v, (n,)).astype(np.int32)
               for n in (9, 30, 17, 12, 25)]
    budgets = [3, 20, 6, 14, 9]
    runs = []
    routed = gen.decode_attention_paged
    for plain in (False, True):
        cb = serve.ContinuousBatcher(
            params, cfg, slots=2, max_len=1024, temperature=0.0,
            prompt_buckets=(64,), paged=True, steps_per_sync=8, device=dev)
        if plain:
            gen.decode_attention_paged = attn.decode_attention_paged_plain
        try:
            rids = [cb.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
            while cb.pending():
                cb.step()
        finally:
            gen.decode_attention_paged = routed
        runs.append((cb, [cb.result(r) for r in rids]))
    (cb, got), (_, plain_got) = runs
    flips = 0
    for p, b, out in zip(prompts, budgets, got):
        flips += check_greedy(torch, port, params, [p], [out], b,
                              "paged handoffs")
    res["handoffs"] = {
        "inblock_refills": cb.stats["inblock_refills"],
        "chained_dispatches": cb.stats["chained_dispatches"],
        "flips": flips,
        "tokens_equal_to_K8_plain": all(
            np.array_equal(x, y) for x, y in zip(got, plain_got))}
    if cb.stats["inblock_refills"] < 1:
        fail(f"paged handoffs: no in-block refill: {cb.stats}")
    if not res["handoffs"]["tokens_equal_to_K8_plain"]:
        fail("paged handoffs: tokens through K8 differ from its plain "
             "version's")
    # (4) one decode step, K8 against the plain paged version
    b, s0 = 4, 200
    toks = torch.from_numpy(rng.integers(0, v, (b, s0))).to(dev)
    cache = gen.init_cache(cfg, b, PAGE, device=dev)
    logits, cache = gen._forward_cached(params, cache, toks,
                                        torch.arange(s0, device=dev), 0,
                                        cfg=cfg, k_len=s0,
                                        unembed_last_only=True)
    tok = torch.argmax(logits[:, 0], -1)
    pos = torch.tensor([s0, s0 - 50, s0 - 120, 3], dtype=torch.int32,
                       device=dev)
    pids = torch.from_numpy(rng.permutation(b) + 2).to(dev)
    table = pids[:, None].to(torch.int32)

    def pool():
        p = gen.init_paged_cache(cfg, b + 2, PAGE, device=dev)
        for name, lyr in p.items():
            for leaf, t in lyr.items():
                t[pids] = cache[name][leaf]
        return p

    kernel_logits = gen.decode_step_ragged(params, pool(), tok, pos,
                                           cfg=cfg, use_decode_kernel=True,
                                           page_table=table)[0]
    routed = gen.decode_attention_paged
    gen.decode_attention_paged = attn.decode_attention_paged_plain
    try:
        plain_logits = gen.decode_step_ragged(
            params, pool(), tok, pos, cfg=cfg, use_decode_kernel=True,
            page_table=table)[0]
    finally:
        gen.decode_attention_paged = routed
    dense_logits = gen.decode_step_ragged(params, cache, tok, pos, cfg=cfg,
                                          use_decode_kernel=True)[0]
    err = (kernel_logits - plain_logits).abs().max().item()
    res["step_logits_max_abs_err"] = err
    res["step_logits_bitwise_equal_to_K6"] = bool(
        torch.equal(kernel_logits, dense_logits))
    print("  f32 paged batcher: " + json.dumps(res))
    # f32 throughout; the kernel and the plain version sum in different
    # orders over 24 layers, as in phase 4
    if not err <= 1e-3:
        fail(f"decode-step logits differ between K8 and plain: {err}")
    del params, cache
    torch.cuda.empty_cache()
    return res


def admission_profile(torch, port, prompts, prefix_cache: bool) -> dict:
    """Single admissions of ``prompts`` (LM-base bf16, the (e) load's
    batcher) with ``max_new=1``, so a ``step()`` is one prefill (or suffix
    prefill over shared pages) and the first token's sample, and nothing
    else.  Two warm-up admissions (with the prefix cache the first
    publishes the shared pages), four timed by the host clock, each ending
    in a synchronize, and four under torch.profiler for their device time
    and device operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tfm, cfg, dev = port["tfm"], port["cfg"], port["dev"]
    params = tfm.init(0, cfg, device=dev, dtype=torch.bfloat16)
    cb = port["serve"].ContinuousBatcher(
        params, cfg, slots=8, max_len=2048, temperature=0.0,
        dtype=torch.bfloat16, prompt_buckets=(128, 512, 1536), paged=True,
        prefix_cache=prefix_cache, device=dev)

    def admit(p):
        cb.submit(p, max_new=1)
        cb.step()

    for p in prompts[:2]:
        admit(p)
    sync(torch)
    walls = []
    for p in prompts[2:6]:
        t0 = time.perf_counter()
        admit(p)
        sync(torch)
        walls.append(time.perf_counter() - t0)
    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        for p in prompts[6:10]:
            admit(p)
        sync(torch)
    us, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us += e.self_device_time_total
            n += e.count
    wall_ms = float(np.mean(walls)) * 1e3
    res = {"wall_ms_per_admission": wall_ms,
           "device_ms_per_admission": us / 1e3 / 4,
           "device_ops_per_admission": n / 4,
           "device_idle_share": 1.0 - us / 1e3 / 4 / wall_ms,
           "prefix_hits": cb.stats["prefix_hits"]}
    del params, cb
    torch.cuda.empty_cache()
    return res


def paired_decode(torch, port, prompts, pairs: int = 2) -> dict:
    """The paged decode step's wall time against the dense one's within
    one stretch of the host's time: a dense and a paged batcher (compaction
    off, so both dispatch all 8 rows) run the same unprofiled decode window
    alternately, dense-paged then paged-dense, ``pairs`` times.  Whole
    loads run minutes apart, and the host's speed drifts between them by
    more than the paged path could cost."""
    tfm, cfg, dev = port["tfm"], port["cfg"], port["dev"]
    params = tfm.init(0, cfg, device=dev, dtype=torch.bfloat16)
    opts = dict(slots=8, max_len=2048, temperature=0.0, dtype=torch.bfloat16,
                prompt_buckets=(128, 512), steps_per_sync=16, device=dev)
    cbs = {"dense": port["serve"].ContinuousBatcher(params, cfg, **opts),
           "paged": port["serve"].ContinuousBatcher(
               params, cfg, paged=True, compact_tail=False, **opts)}
    for cb in cbs.values():  # warm-up
        decode_window(torch, cb, prompts[:8], 1, profiled=False, max_new=32)
    walls = {"dense": [], "paged": []}
    for i in range(pairs):
        for key in (("dense", "paged"), ("paged", "dense"))[i % 2]:
            walls[key].append(decode_window(
                torch, cbs[key], prompts[:8], 2,
                profiled=False)["wall_ms_per_decode_step"])
    ratios = [p / d for p, d in zip(walls["paged"], walls["dense"])]
    del params, cbs
    torch.cuda.empty_cache()
    return {"dense_ms_per_decode_step": walls["dense"],
            "paged_ms_per_decode_step": walls["paged"],
            "paged_over_dense": ratios,
            "median_paged_over_dense": float(np.median(ratios))}


def paged_serving(torch, port, dense_tokens) -> dict:
    """Phase 11's loads, (a)-(e), on LM-base bf16; ``dense_tokens`` are
    phase 5's bf16 load outputs, which load (a) must equal request by
    request (K8 is bitwise K6, and prefill, insert and GEMM shapes are the
    same)."""
    cfg = port["cfg"]
    load16 = phase5_load(cfg, 16, (64, 256))
    load8 = phase5_load(cfg, 8, (32, 64))
    short = dict(window_new=32)  # lighter idle-share window
    res = {"a": serving_run(torch, port, label="(a) paged, default pool, "
                            "compact_tail=False", prompts=load16[0],
                            max_new=load16[1], paged=True,
                            compact_tail=False)}
    bad = [i for i, (x, y) in enumerate(zip(res["a"]["tokens"], dense_tokens))
           if not np.array_equal(x, y)]
    if bad:
        fail(f"(a): paged tokens differ from phase 5's dense tokens for "
             f"requests {bad}")
    print(f"  (a): tokens equal phase 5's dense tokens for all "
          f"{len(dense_tokens)} requests")
    res["b"] = serving_run(torch, port, label="(b) paged, compact_tail=True",
                           prompts=load16[0], max_new=load16[1], paged=True,
                           window_blocks=0)
    if res["b"]["compact_dispatches"] < 1:
        fail("(b): no compact dispatch")
    res["c"] = serving_run(torch, port, label="(c) paged, pool_pages=9",
                           prompts=load16[0], max_new=load16[1], paged=True,
                           pool_pages=9, window_blocks=0)
    if not (res["c"]["evictions"] >= 1
            and res["c"]["swap_ins"] == res["c"]["evictions"]):
        fail(f"(c): evictions {res['c']['evictions']}, swap-ins "
             f"{res['c']['swap_ins']}")
    res["d"] = serving_run(torch, port, label="(d) paged int8 pool (K9)",
                           prompts=load8[0], max_new=load8[1], paged=True,
                           kv_dtype="int8", **short)
    rng = np.random.default_rng(5)
    sysp = rng.integers(0, cfg.vocab_size, (1024,)).astype(np.int32)
    prompts = [np.concatenate([sysp, rng.integers(
        0, cfg.vocab_size, (int(n),)).astype(np.int32)])
        for n in rng.integers(16, 201, 16)]
    max_new = [int(m) for m in rng.integers(32, 65, 16)]
    kw = dict(prompts=prompts, max_new=max_new, paged=True,
              prompt_buckets=(128, 512, 1536))
    res["e"] = serving_run(torch, port, label="(e) shared 1024-token "
                           "system prompt, prefix cache", prefix_cache=True,
                           window_blocks=0, **kw)
    if res["e"]["prefix_hits"] != 15 or res["e"]["prefix_pages_shared"] != 30:
        fail(f"(e): {res['e']['prefix_hits']} prefix hits sharing "
             f"{res['e']['prefix_pages_shared']} pages (want 15 and 30)")
    # batched prefills on both sides: a cached prefix never admits
    # in-block, and in-block refill would teacher-force these 1,040-1,224
    # token prompts a token a step
    res["e0"] = serving_run(torch, port, label="(e) the same load without "
                            "the prefix cache, in-block refill off",
                            window_blocks=0, inblock_refill=False, **kw)
    print(f"  (e) ms per prefill: {res['e']['ms_per_prefill']:.3f} with the "
          f"prefix cache, {res['e0']['ms_per_prefill']:.3f} without "
          f"({res['e0']['ms_per_prefill'] / res['e']['ms_per_prefill']:.2f}"
          f"x)")
    # where an admission's time goes: device vs host, suffix vs full prefill
    res["admission"] = {
        key: admission_profile(torch, port, prompts, prefix_cache=on)
        for key, on in (("prefix_cache", True), ("full_prefill", False))}
    print("  (e) single admissions: " + json.dumps(res["admission"]))
    if res["admission"]["prefix_cache"]["prefix_hits"] != 9:
        fail(f"(e) admissions: {res['admission']} (want 9 prefix hits)")
    res["paired"] = paired_decode(torch, port, load16[0])
    print("  dense and paged decode windows, alternated: "
          + json.dumps(res["paired"]))
    return res


# -- phase 18: serving scheduling ------------------------------------------

def scheduling_exactness(torch, port) -> dict:
    """Phase 18 (a): LM-base f32 against static generate() (check_greedy),
    on phase 4's prompts: the batcher with prefill_chunk=64 and with
    speculate=4 (dense and paged), generate_lookup, and
    generate_speculative with a 2-layer LM-base-width draft (random
    weights: its acceptance is reported, not gated)."""
    import dataclasses
    tfm, gen, serve = port["tfm"], port["gen"], port["serve"]
    cfg, dev = port["cfg"], port["dev"]
    params = tfm.init(0, cfg, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(1)
    lens, max_new = (7, 45, 130, 300), 24   # phase 4's load
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    wants = greedy_refs(port, params, prompts, max_new)
    res = {}
    # four slots for the chunked run: every prompt admits chunk by chunk
    # from the idle pool (300 tokens: 5 chunks)
    for label, kw in (("prefill_chunk=64", dict(prefill_chunk=64, slots=4)),
                      ("speculate=4", dict(speculate=4, slots=2)),
                      ("speculate=4 paged", dict(speculate=4, slots=2,
                                                 paged=True))):
        cb = serve.ContinuousBatcher(
            params, cfg, max_len=512, temperature=0.0,
            prompt_buckets=(64, 512), device=dev, **kw)
        got = cb.run(prompts, max_new=max_new)
        st = cb.stats
        res[label] = {"flips": check_greedy(torch, port, params, prompts,
                                            got, max_new, label, wants),
                      **{k: st[k] for k in (
                          "prefill_dispatches", "batch_admissions",
                          "inblock_refills", "spec_rounds", "spec_proposed",
                          "spec_accepted")}}
        if kw.get("speculate") and not st["spec_rounds"]:
            fail(f"{label}: no speculation round ran: {st}")
        if kw.get("prefill_chunk") and \
                st["prefill_dispatches"] <= st["batch_admissions"]:
            fail(f"{label}: no admission took more than one chunk: {st}")
    outs, rounds = [], 0
    for p in prompts:
        toks, st = gen.generate_lookup(params, p[None], cfg=cfg,
                                       max_new=max_new, device=dev)
        outs.append(toks[0].cpu().numpy())
        rounds += st["rounds"]
    res["generate_lookup"] = {
        "flips": check_greedy(torch, port, params, prompts, outs, max_new,
                              "generate_lookup", wants),
        "rounds": rounds}
    dcfg = dataclasses.replace(cfg, n_layers=2)
    draft = tfm.init(1, dcfg, device=dev, dtype=torch.float32)
    outs, acc = [], {"rounds": 0, "drafted": 0, "accepted": 0}
    for p in prompts:
        toks, st = gen.generate_speculative(
            params, draft, p[None], cfg=cfg, draft_cfg=dcfg,
            max_new=max_new, n_spec=4, device=dev)
        outs.append(toks[0].cpu().numpy())
        acc = {k: acc[k] + st[k] for k in acc}
    res["generate_speculative"] = {
        "flips": check_greedy(torch, port, params, prompts, outs, max_new,
                              "generate_speculative", wants),
        **acc, "acceptance": acc["accepted"] / max(acc["drafted"], 1)}
    print("  f32 scheduling paths vs static generate: " + json.dumps(res))
    del params, draft
    torch.cuda.empty_cache()
    return res


def overlap_windows(torch, port, load, pairs: int = 2,
                    decode_pairs: int = 1, decode_blocks: int = 3,
                    profile_load: bool = False, base: dict | None = None
                    ) -> dict:
    """Phase 18 (b): LM-base bf16, phase 5's batcher (8 slots, 16 steps a
    block, in-block refill on) with overlap on (A) against off (B).

    Load windows: each serves ``load`` (phase 5's 16 requests at their
    64-256 budgets) from a drained batcher to its end, alternated A B B A
    ``pairs`` times (``pairs=0``: one window a side, the overlapped one
    ``base``, phase 5's run of the same load under the same batcher, when
    given); with ``profile_load``, then one profiled load window
    of each (CUDA activity only: the load's device time and operations
    per emitted token; ~75 s each with the profile's parse).  Decode
    windows (decode_window): the load's first 8 prompts admitted, then
    ``decode_blocks`` blocks with every slot decoding, each one chained
    under overlap (the steady state the mechanism is for), alternated A B
    B A ``decode_pairs`` times, then one profiled window of each (device
    time and operations a step, the idle share).  Fails unless every load
    window gives the first one's tokens bitwise, and only the overlapped
    side chained."""
    from torch.profiler import ProfilerActivity, profile
    tfm, serve, cfg, dev = port["tfm"], port["serve"], port["cfg"], \
        port["dev"]
    prompts, budgets = load
    params = tfm.init(0, cfg, device=dev, dtype=torch.bfloat16)
    opts = dict(slots=8, max_len=2048, temperature=0.0, dtype=torch.bfloat16,
                prompt_buckets=(128, 512), steps_per_sync=16, device=dev)
    cbs = {on: serve.ContinuousBatcher(params, cfg, overlap=on, **opts)
           for on in (True, False)}
    keys = ("emitted_tokens", "decode_steps", "decode_dispatches",
            "chained_dispatches")

    def window(cb, profiled=False):
        st0 = dict(cb.stats)
        rids = [cb.submit(p, max_new=m) for p, m in zip(prompts, budgets)]
        sync(torch)
        prof = profile(activities=[ProfilerActivity.CUDA]) \
            if profiled else None
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        while cb.pending():
            cb.step()
        sync(torch)
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
        d = {k: cb.stats[k] - st0[k] for k in keys}
        d.update(wall_s=wall, tokens=[cb.result(r) for r in rids])
        if prof is not None:
            ev = device_events(prof).values()
            d.update(device_ms=sum(us for us, _ in ev) / 1e3,
                     device_ops=sum(n for _, n in ev))
        return d

    def alternate(fn, n_pairs, base=None):
        runs = {True: [], False: []}
        if n_pairs == 0:  # one window a side
            for on in (True, False):
                runs[on].append(base if on and base is not None
                                else fn(cbs[on]))
        for i in range(2 * n_pairs):
            for on in ((True, False), (False, True))[i % 2]:
                runs[on].append(fn(cbs[on]))
        return runs

    def decode(cb, profiled=False):
        c0 = cb.stats["chained_dispatches"]
        w = decode_window(torch, cb, prompts[:8], decode_blocks,
                          profiled=profiled,
                          max_new=16 * (decode_blocks + 2))
        w["chained_dispatches"] = cb.stats["chained_dispatches"] - c0
        return w

    runs = alternate(window, pairs, base)
    profs = {on: window(cbs[on], profiled=True) for on in (True, False)} \
        if profile_load else {}
    ref = runs[True][0]["tokens"]
    for on, ws in runs.items():
        for w in ws + ([profs[on]] if profs else []):
            bad = [i for i, (x, y) in enumerate(zip(w["tokens"], ref))
                   if not np.array_equal(x, y)]
            if bad:
                fail(f"(b) overlap={on}: tokens differ from the first "
                     f"window's for requests {bad}")
    dec = alternate(decode, decode_pairs)
    dprof = {on: decode(cbs[on], profiled=True) for on in (True, False)}
    res = {}
    for on, ws in runs.items():
        walls = [w["wall_s"] for w in ws]
        emitted, steps = ws[0]["emitted_tokens"], ws[0]["decode_steps"]
        dp = dprof[on]
        dwall = [w["wall_ms_per_decode_step"] for w in dec[on]]
        side = {
            "wall_s": walls,
            "tokens_per_s": [emitted / w for w in walls],
            "wall_ms_per_decode_step": [w * 1e3 / steps for w in walls],
            **{k: ws[0][k] for k in keys},
            "decode_windows": {
                "wall_ms_per_decode_step": dwall,
                "decode_steps": dp["decode_steps"],
                "chained_dispatches": dp["chained_dispatches"],
                "device_ms_per_decode_step": dp["device_ms_per_decode_step"],
                "device_ops_per_decode_step":
                    dp["device_ops_per_decode_step"],
                "device_ops_per_emitted_token":
                    dp["device_ops_per_decode_step"] / 8,
                "device_idle_share": 1.0 - dp["device_ms_per_decode_step"]
                / float(np.mean(dwall)),
                "top_kernels": dp["top_kernels"][:3]}}
        if profs:
            pw = profs[on]
            side["profiled_load_window"] = {k: pw[k] for k in (
                "wall_s", "emitted_tokens", "decode_steps", "device_ms",
                "device_ops")}
            side["device_idle_share"] = 1.0 - pw["device_ms"] / (
                float(np.mean(walls)) * 1e3)
            side["device_ops_per_emitted_token"] = pw["device_ops"] \
                / pw["emitted_tokens"]
        res["on" if on else "off"] = side
    for name, get in (
            ("on_over_off_tokens_per_s",
             lambda s: np.mean(res[s]["tokens_per_s"])),
            ("decode_windows_on_over_off_ms_per_step",
             lambda s: np.mean(res[s]["decode_windows"][
                 "wall_ms_per_decode_step"]))):
        res[name] = float(get("on") / get("off"))
    on, off = res["on"], res["off"]
    if not on["chained_dispatches"] or off["chained_dispatches"] or \
            on["decode_windows"]["chained_dispatches"] < decode_blocks or \
            off["decode_windows"]["chained_dispatches"]:
        fail(f"(b) chained dispatches: {res}")
    print("  (b) overlap on against off, phase 5's load and pure-decode "
          "windows, alternated: " + json.dumps(res))
    del params, cbs
    torch.cuda.empty_cache()
    return res


def token_flips(a_tokens, b_tokens, prompts) -> list:
    """(request, first differing generated position) for each request
    whose two token streams differ."""
    flips = []
    for i, (a, b, p) in enumerate(zip(a_tokens, b_tokens, prompts)):
        diff = np.nonzero(a != b)[0]
        if len(diff):
            flips.append([i, int(diff[0]) - len(p)])
    return flips


def lookup_load(cfg, n_req: int = 16, max_new: int = 32):
    """Phase 18 (d)'s lookup-friendly load: each prompt a random 16-token
    motif tiled to 128-480 tokens (seed 7)."""
    rng = np.random.default_rng(7)
    prompts = []
    for n in rng.integers(128, 481, n_req):
        motif = rng.integers(0, cfg.vocab_size, (16,)).astype(np.int32)
        prompts.append(np.tile(motif, -(-int(n) // 16))[:int(n)])
    return prompts, [max_new] * n_req


def scheduling_serving(torch, port, base) -> dict:
    """Phase 18 (b)-(e) at LM-base bf16.  ``base`` is phase 5's K6 run: the
    16-request load under the default scheduler (in-block refill and
    overlap on, unchunked), the side each comparison below is held
    against."""
    cfg = port["cfg"]
    load16 = phase5_load(cfg, 16, (64, 256))
    # one load window a side, the overlapped one phase 5's run (A B B A
    # twice before slice 6b's phase 20 took its time, once before slice
    # 5c-ii's phase 24 did: none resolved a gain, PERF.md section 6);
    # every gate stands
    res = {"b": overlap_windows(torch, port, load16, pairs=0, base=base)}
    keys = ("tokens_per_s", "utilization", "emitted_per_slot_step",
            "inblock_refills", "inblock_prefill_steps",
            "chained_dispatches", "ttft_p50_s", "ttft_p95_s",
            "decode_steps", "wall_s")
    off = serving_run(torch, port, label="(c) inblock_refill=False",
                      prompts=load16[0], max_new=load16[1],
                      inblock_refill=False, window_blocks=0)
    res["c"] = {"on": {k: base[k] for k in keys},
                "off": {k: off[k] for k in keys},
                "bf16_token_flips_on_vs_off": token_flips(
                    base["tokens"], off["tokens"], load16[0])}
    print("  (c) in-block refill on (phase 5's run) against off: "
          + json.dumps(res["c"]))
    prompts, max_new = lookup_load(cfg)
    spec = serving_run(torch, port, label="(d) speculate=4, lookup-friendly "
                       "load", prompts=prompts, max_new=max_new,
                       speculate=4, window_blocks=0)
    plain = serving_run(torch, port, label="(d) speculate=0, the same load",
                        prompts=prompts, max_new=max_new, window_blocks=0)
    if spec["launches"] or spec["decode_steps"] or not spec["spec_rounds"]:
        fail(f"(d): the speculative run launched the decode kernel "
             f"{spec['launches']} times over {spec['decode_steps']} "
             f"lockstep steps ({spec['spec_rounds']} verify rounds)")
    sampled = spec["emitted_tokens"] - spec["batch_admissions"]
    res["d"] = {
        "speculate=4": {k: spec[k] for k in keys + (
            "spec_rounds", "spec_proposed", "spec_accepted")},
        "speculate=0": {k: plain[k] for k in keys},
        "acceptance": spec["spec_accepted"] / max(spec["spec_proposed"], 1),
        "verify_rounds_per_emitted_token": spec["spec_rounds"]
        / max(sampled, 1),
        "tokens_per_s_spec_over_plain": spec["tokens_per_s"]
        / plain["tokens_per_s"],
        "bf16_token_flips_spec_vs_plain": token_flips(
            spec["tokens"], plain["tokens"], prompts)}
    print("  (d) speculation: " + json.dumps(res["d"]))
    chunk = serving_run(torch, port, label="(e) prefill_chunk=128",
                        prompts=load16[0], max_new=load16[1],
                        prefill_chunk=128, window_blocks=0)
    res["e"] = {"chunked": {k: chunk[k] for k in keys + (
        "prefill_dispatches", "batch_admissions")},
        "unchunked": {k: base[k] for k in keys + (
            "prefill_dispatches", "batch_admissions")},
        "bf16_token_flips_chunked_vs_unchunked": token_flips(
            chunk["tokens"], base["tokens"], load16[0])}
    print("  (e) chunked prefill against phase 5's unchunked run: "
          + json.dumps(res["e"]))
    return res


# -- phases 12-14: the VGG-training slice ----------------------------------

BN_KERNELS = ("K1a", "K1b")
VGG_BATCH = 256  # the reference's batch (main.py:18)


def vgg_bn_layers(vgg, name: str, batch: int) -> list[tuple[int, int, int]]:
    """(N, H, C) of every BatchNorm of ``name`` at ``batch``: the (M, C)
    rows K1a/K1b see are M = N * H * H (32x32 input, a 2x2 pool per 'M')."""
    h, out = 32, []
    for c in vgg.CFG[name]:
        if c == "M":
            h //= 2
        else:
            out.append((batch, h, c))
    return out


def vgg11_train_flops_per_sample() -> float:
    """bench.py's analytic training FLOPs per sample of VGG-11 on 32x32:
    conv MACs H*W*Cin*Cout*9 per stage plus the fc head, x2 FLOPs/MAC, x3
    for forward, input gradient and weight gradient (BN/ReLU/pool
    excluded) = 916.6 MFLOP."""
    cfg = [(32, 3, 64), (16, 64, 128), (8, 128, 256), (8, 256, 256),
           (4, 256, 512), (4, 512, 512), (2, 512, 512), (2, 512, 512)]
    macs = sum(h * h * cin * cout * 9 for h, cin, cout in cfg) + 512 * 10
    return 2 * 3 * macs


def ulp_neighbours(torch, e):
    """The representable values just above and just below |e| (sign kept),
    in e's dtype."""
    itype = torch.int32 if e.dtype == torch.float32 else torch.int16
    mag = e.abs().contiguous().view(itype)
    sign = torch.where(e < 0, -1.0, 1.0).to(e.dtype)
    up = (mag + 1).view(e.dtype) * sign
    down = torch.where(mag > 0, mag - 1, mag).view(e.dtype) * sign
    return up, down


def bn_case(torch, m: int, c: int, dtype, seed: int):
    """(dr, a, mean, rstd, gamma, beta) on the device: (M, C) rows with
    per-channel scale and shift, their batch statistics, and every 7th row
    set so the forward's y lands exactly on 0 (a = mean where beta = 0),
    near 0 through beta (a = mean - beta / inv), or one ulp either side of
    that; |dr| in [0.5, 2] so a flipped mask shows in da."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=DEVICE)

    def uni(*shape):
        return torch.rand(shape, generator=g, device=DEVICE)

    a = (rnd(m, c) * (0.5 + uni(c)) + 0.3 * rnd(c)).to(dtype)
    gamma = 1.0 + 0.2 * rnd(c)
    beta = 0.2 * rnd(c)
    beta[: c // 4] = 0.0
    a32 = a.float()
    mean = a32.mean(0)
    rstd = torch.rsqrt((a32 * a32).mean(0) - mean * mean + 1e-5)
    inv_t = (rstd * gamma).to(dtype).float()
    edge = (mean.to(dtype).float() - beta.to(dtype).float() / inv_t).to(dtype)
    up, down = ulp_neighbours(torch, edge)
    a[0::7] = mean.to(dtype)
    a[3::7] = edge
    a[4::7] = up
    a[5::7] = down
    dr = ((0.5 + 1.5 * uni(m, c))
          * torch.where(uni(m, c) < 0.5, -1.0, 1.0)).to(dtype)
    return dr, a, mean, rstd, gamma, beta


def bn_check_case(torch, fb, nn, m, c, dtype, seed) -> dict:
    """K1a/K1b against bn_relu_bwd_plain on one case: s1, s2 within 1e-5 of
    max|s| (summation order), da float32 within 1e-5 of max|da| and bf16
    within one bf16 ulp of the plain value (plus the float32 bound), the
    masks element for element (read back from da: dy = da / (gamma rstd) +
    (s1 + xhat s2) / M), and a second run bitwise equal."""
    dr, a, mean, rstd, gamma, beta = bn_case(torch, m, c, dtype, seed)
    args = (dr, a, mean, rstd, gamma, beta)
    s1, s2 = fb.bn_relu_bwd_reduce(*args)
    da = fb.bn_relu_bwd_apply(*args, s1, s2)
    s1b, s2b = fb.bn_relu_bwd_reduce(*args)
    dab = fb.bn_relu_bwd_apply(*args, s1b, s2b)
    ra, rg, rb = fb.bn_relu_bwd_plain(*args)
    sync(torch)
    sum_ratio = max(((got - ref).abs().max() / (1e-5 * ref.abs().max()))
                    .item() for got, ref in ((s1, rb), (s2, rg)))
    sum_err = max((got - ref).abs().max().item()
                  for got, ref in ((s1, rb), (s2, rg)))
    ref = ra.float()
    err = (da.float() - ref).abs()
    tol = 1e-5 * ref.abs().max()
    if dtype == torch.bfloat16:
        _, e = torch.frexp(ref)
        tol = tol + torch.where(ref != 0, torch.ldexp(torch.ones_like(ref),
                                                      e - 8), 0.0)
    y = nn.normalize(a, mean, (rstd * gamma).to(dtype), beta)
    xhat = (a.float() - mean) * rstd
    dy = da.float() / (gamma * rstd) + (s1 + xhat * s2) / m
    return {"K1a": (sum_err, sum_ratio),
            "K1b": (err.max().item(), (err / tol).max().item()),
            "mask_mismatches": int(((dy.abs() > 0.25) != (y > 0)).sum()),
            "y_zero": int((y == 0).sum()),
            # within a few ulps of 0, i.e. of beta's rounding residue
            "y_tiny": int(((y != 0) & (y.float().abs() <= 8 * torch.finfo(
                dtype).eps * beta.abs())).sum()),
            "bitwise_repeat": bool(torch.equal(s1, s1b)
                                   and torch.equal(s2, s2b)
                                   and torch.equal(da, dab))}


def check_bn_kernels(torch, fb, nn, vgg) -> dict:
    """Phase 12's agreement cases: the eight VGG-11 batch-256 BN shapes
    (five distinct) and three TINY widths (C 8, 16, 32), in float32 and
    bfloat16, and three row counts that are no multiple of any block, all
    with rows on the ReLU's edge; then the 4-D path of bn_relu_bwd, with a
    gradient that is not channels_last (one counted copy)."""
    shapes = sorted({(n * h * h, c) for n, h, c in
                     vgg_bn_layers(vgg, "VGG11", VGG_BATCH)}, reverse=True)
    shapes += [(n * h * h, c) for n, h, c in
               vgg_bn_layers(vgg, "TINY", VGG_BATCH)[::3]]
    cases = [(m, c, dt) for m, c in shapes
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(100003, 64, torch.float32), (777, 512, torch.bfloat16),
              (12345, 8, torch.float32)]
    # the plan's largest partial count: one channel tile (C = 64 bf16) and
    # rows enough for every one of its row blocks, M no multiple of them
    big = (300007, 64, torch.bfloat16)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fb._plan(fb._lib(), big[0], big[1], 8, 2, n_sm)
    tiles, blocks = plan["tiles"], plan["blocks"]
    if tiles != 1 or blocks != fb._plan(fb._lib(), 2 ** 24, big[1], 8, 2,
                                        n_sm)["blocks"]:
        fail(f"the largest-partial case is not: {tiles} tiles x {blocks} "
             f"blocks on {n_sm} SMs")
    cases.append(big)
    worst = {k: [0.0, 0.0] for k in BN_KERNELS}
    for i, (m, c, dt) in enumerate(cases):
        res = bn_check_case(torch, fb, nn, m, c, dt, seed=200 + i)
        print(f"  {str(dt)[6:]:8s} M={m:6d} C={c:3d}: s1/s2 "
              f"{res['K1a'][1]:.3f} of tol, da {res['K1b'][1]:.3f} of tol, "
              f"{res['mask_mismatches']} mask mismatches, y==0 "
              f"{res['y_zero']}, 0<|y|<=8eps|beta| {res['y_tiny']}, repeat "
              f"bitwise {res['bitwise_repeat']}")
        for k in BN_KERNELS:
            worst[k][0] = max(worst[k][0], res[k][0])
            worst[k][1] = max(worst[k][1], res[k][1])
        if not (res["K1a"][1] <= 1.0 and res["K1b"][1] <= 1.0):
            fail(f"K1a/K1b disagree with bn_relu_bwd_plain at M={m} C={c} "
                 f"{dt}: {res}")
        if res["mask_mismatches"] or not res["bitwise_repeat"]:
            fail(f"K1a/K1b masks or repeatability at M={m} C={c} {dt}: "
                 f"{res}")
        if not (res["y_zero"] and res["y_tiny"]):
            fail(f"the case M={m} C={c} {dt} has no y on or next to 0")
    # an arrival counter left non-zero, or a merge that follows the
    # arrivals, shows in back-to-back launches on one input
    for m, c, dt in ((VGG_BATCH * 32 * 32, 64, torch.bfloat16), big,
                     (VGG_BATCH * 2 * 2, 512, torch.float32)):
        args = bn_case(torch, m, c, dt, 250)
        s = fb.bn_relu_bwd_reduce(*args)
        repeat_bitwise(torch, lambda: torch.cat(
            fb.bn_relu_bwd_reduce(*args)), torch.cat(s),
            f"K1a M={m} C={c} {dt}", n=50)
        repeat_bitwise(torch, lambda: fb.bn_relu_bwd_apply(*args, *s),
                       fb.bn_relu_bwd_apply(*args, *s),
                       f"K1b M={m} C={c} {dt}", n=50)
    print(f"  K1a and K1b each 52 launches bitwise equal on one input, at "
          f"three shapes (one with {blocks} partials a tile)")
    # the 4-D path: channels_last activation, a gradient in NCHW order
    n, h, c = 32, 16, 128
    dr, a, mean, rstd, gamma, beta = bn_case(torch, n * h * h, c,
                                             torch.float32, 300)
    a4 = a.view(n, h, h, c).permute(0, 3, 1, 2)
    dr4 = dr.view(n, h, h, c).permute(0, 3, 1, 2).contiguous()
    copies = fb.bn_relu_bwd.copies
    got = fb.bn_relu_bwd(dr4, a4, mean, rstd, gamma, beta)
    want = fb.bn_relu_bwd_plain(dr4, a4, mean, rstd, gamma, beta)
    sync(torch)
    if fb.bn_relu_bwd.copies != copies + 1 or not \
            got[0].is_contiguous(memory_format=torch.channels_last):
        fail("bn_relu_bwd's 4-D path: copy count or da layout wrong")
    err = (got[0] - want[0]).abs().max().item()
    if not err <= 1e-5 * want[0].abs().max().item():
        fail(f"bn_relu_bwd's 4-D path disagrees with the plain version: "
             f"{err}")
    print(f"  K1a/K1b agree with bn_relu_bwd_plain in all {len(cases)} "
          f"cases and on the 4-D path (one counted copy of an NCHW dr)")
    return {k: {"max_abs_err": e, "err_over_tol": r}
            for k, (e, r) in worst.items()}


def _rotation(torch, fb, nn, n, h, c, dtype, nbytes_each: int) -> list:
    """Enough independent input sets of one layer to rotate past the 50 MB
    L2: (args, (s1, s2), dy4, a4, dr4) per set, dy4 the masked gradient as
    the library call takes it, dr4 and a4 the (N, C, H, W) channels_last
    views bn_relu_bwd takes in the step."""
    sets = []
    for i in range(max(2, math.ceil(150e6 / nbytes_each))):
        args = bn_case(torch, n * h * h, c, dtype, 400 + i)
        s = fb.bn_relu_bwd_reduce(*args)
        dr, a, mean, rstd, gamma, beta = args
        y = nn.normalize(a, mean, (rstd * gamma).to(dtype), beta)
        dy = torch.where(y > 0, dr, torch.zeros((), dtype=dtype,
                                                device=DEVICE))
        sets.append((args, s) + tuple(t.view(n, h, h, c).permute(0, 3, 1, 2)
                                      for t in (dy, a, dr)))
    return sets


def _summed_windows(step_rows: list) -> dict:
    """K1a + K1b as the step runs them against the library, over layers:
    each alternated window summed over the layers (a layer as often as the
    model has it), then the mean of the per-pair ratios.  Each window
    holds a producer kernel before every call (see ``time_bn_kernels``):
    the ratio is of the windows as measured, ``ms`` and ``library_ms`` net
    of the producer's own time."""
    k = np.sum([r["ms_windows"] for r in step_rows], axis=0)
    lib = np.sum([r["library_ms_windows"] for r in step_rows], axis=0)
    prod = float(np.sum([r["producer_ms"] for r in step_rows]))
    return {"ms": float(np.mean(k)) - prod,
            "library_ms": float(np.mean(lib)) - prod, "producer_ms": prod,
            "ms_windows": k.tolist(), "library_ms_windows": lib.tolist(),
            "over_library": float(np.mean(k / lib))}


def time_bn_kernels(torch, fb, nn, vgg, facts) -> dict:
    """K1a and K1b at every VGG-11 batch-256 BN layer, float32 and bf16.

    Each kernel alone, inputs rotated past the L2: device ms by CUDA events
    beside the byte bound (each input read once, each output written once,
    over the memory rate), the plain closed form (bn_relu_bwd_plain, both
    kernels' work) and the library yardstick: aten
    native_batch_norm_backward in train mode, given the saved mean and
    invstd, on the already-masked dy (it has no ReLU mask; the port never
    calls it).  Then both kernels as the step runs them (bn_relu_bwd on one
    rotated input set: K1a, then K1b on the same rows) against the library
    call, in alternated windows.  Reported per layer, for the largest
    layer and summed over the eight.

    In the step K1a follows a kernel that does not launch its dependents
    early (the convolution backward that makes dr), so K1a's programmatic
    launch gets no overlap there; K1b follows K1a, which does.  So every
    K1a call here, alone or as the step runs it, and every library call
    in the alternated windows, comes after such a producer kernel (a
    one-element fill); the K1a time and the windows' ``ms`` are net of
    the producer's own time alone, the windows' ratio is as measured
    (the same producer on both sides)."""
    out = {}
    layers = vgg_bn_layers(vgg, "VGG11", VGG_BATCH)
    launches0 = (fb.bn_relu_bwd_reduce.launches,
                 fb.bn_relu_bwd_apply.launches)
    tick = torch.zeros(1, device=DEVICE)

    def producer():
        tick.zero_()

    for dtype in (torch.bfloat16, torch.float32):
        dt, isz = str(dtype)[6:], torch.finfo(dtype).bits // 8
        rows, tot = [], {k: 0.0 for k in ("K1a", "K1b", "plain", "library",
                                          "bound_K1a", "bound_K1b")}
        timed, step_rows = {}, []
        for n, h, c in layers:
            key = (n, h, c)
            if key not in timed:
                m = n * h * h
                sets = _rotation(torch, fb, nn, n, h, c, dtype,
                                 2 * m * c * isz)
                it = [0]

                def pick():
                    it[0] = (it[0] + 1) % len(sets)
                    return sets[it[0]]

                def k1a():
                    args = pick()[0]
                    producer()
                    fb.bn_relu_bwd_reduce(*args)

                def k1b():
                    args, s = pick()[:2]
                    fb.bn_relu_bwd_apply(*args, *s)

                def step():
                    args, _, _, a4, dr4 = pick()
                    producer()
                    fb.bn_relu_bwd(dr4, a4, *args[2:])

                def plain():
                    args = pick()[0]
                    fb.bn_relu_bwd_plain(*args)

                def library():
                    args, _, dy4, a4, _ = pick()
                    _, _, mean, rstd, gamma, _ = args
                    torch.ops.aten.native_batch_norm_backward(
                        dy4, a4, gamma, None, None, mean, rstd, True, 1e-5,
                        [True, True, True])

                def library_step():
                    producer()
                    library()

                prod = time_ms(torch, producer, iters=20)
                row = {"M": m, "C": c,
                       "K1a": time_ms(torch, k1a, iters=20) - prod,
                       "K1b": time_ms(torch, k1b, iters=20),
                       "plain": time_ms(torch, plain, iters=5),
                       "producer": prod}
                try:
                    row["library"] = time_ms(torch, library, iters=20)
                except RuntimeError as e:  # a yardstick only
                    print(f"  library call refused at {key} {dt}: {e}")
                    row["library"] = None
                row["step"] = None
                if row["library"] is not None:
                    st = alternated(torch, step, library_step, iters=20)
                    st.update(ms=st["ms"] - prod, producer_ms=prod,
                              library_ms=st["library_ms"] - prod)
                    row["step"] = st
                row["bound_K1a"] = (2 * m * c * isz + 24 * c) / facts["bw"] \
                    * 1e3
                row["bound_K1b"] = (3 * m * c * isz + 32 * c) / facts["bw"] \
                    * 1e3
                for k in BN_KERNELS:
                    row[f"share_{k}"] = row[f"bound_{k}"] / row[k]
                timed[key] = row
                st = row["step"] or {"ms": float("nan"),
                                     "library_ms": float("nan"),
                                     "over_library": float("nan")}
                print(f"  {dt:8s} M={m:6d} C={c:3d}: K1a {row['K1a']:.4f} ms "
                      f"({row['share_K1a']:.2f} of its {row['bound_K1a']:.5f}"
                      f" bound), K1b {row['K1b']:.4f} ({row['share_K1b']:.2f}"
                      f" of {row['bound_K1b']:.5f}), library "
                      f"{row['library'] or float('nan'):.4f}; as the step "
                      f"runs them {st['ms']:.4f} vs library "
                      f"{st['library_ms']:.4f}, ratio {st['over_library']:.3f}"
                      f" (alternated, after a producer of {prod:.4f})")
                del sets
            row = timed[key]
            rows.append(row)
            if row["step"] is not None:
                step_rows.append(row["step"])
            for k in tot:
                tot[k] = None if (tot[k] is None or row[k] is None) \
                    else tot[k] + row[k]
        largest = max(rows, key=lambda r: r["M"] * r["C"])
        steps = _summed_windows(step_rows) \
            if len(step_rows) == len(rows) else None
        out[dt] = {"layers": list(timed.values()), "sum_8_layers": tot,
                   "largest_layer": largest, "step_8_layers": steps}
        print(f"  {dt} over the 8 VGG-11 layers (batch 256): "
              + json.dumps(tot))
        print(f"  {dt} largest layer (M={largest['M']}, C={largest['C']}): "
              + json.dumps({k: largest[k] for k in tot}))
        if steps:
            print(f"  {dt} K1a + K1b as the step runs them, 8 layers: "
                  f"{steps['ms']:.4f} ms vs native_batch_norm_backward "
                  f"{steps['library_ms']:.4f} ms, ratio "
                  f"{steps['over_library']:.3f} (alternated windows "
                  f"{[round(x, 4) for x in steps['ms_windows']]} / "
                  f"{[round(x, 4) for x in steps['library_ms_windows']]}, "
                  f"each with {steps['producer_ms']:.4f} ms of producer "
                  f"kernels); {facts['smi']}")
    fb.bn_relu_bwd_reduce.launches, fb.bn_relu_bwd_apply.launches = \
        launches0  # timing launches are not counted
    torch.cuda.empty_cache()
    return out


def _rel_gap(a: dict, b: dict, skip=()) -> float:
    """Worst over tensors (but ``skip``) of max|a - b| / max|b|."""
    return max((a[k] - b[k]).abs().max().item() / b[k].abs().max().item()
               for k in b if k not in skip)


def _grad_gaps(a: dict, b: dict) -> tuple[float, float]:
    """(worst relative gap over the weight tensors, worst absolute gap of
    the conv biases over G): a conv bias's true gradient is 0 (the BN
    after it cancels it), so its values are rounding noise and are held
    on the scale of G, the largest gradient entry of any tensor."""
    biases = [k for k in b if k.startswith("conv") and k.endswith(".bias")]
    g = max(t.abs().max().item() for t in b.values())
    return (_rel_gap(a, b, skip=biases),
            max((a[k] - b[k]).abs().max().item() for k in biases) / g)


GRAD_TOL = 1e-3       # fused vs plain f32 gradients, relative per tensor
BIAS_GRAD_TOL = 1e-4  # the conv biases' gradient noise, over G
# Params after 10 SGD steps at lr 0.1: early VGG training amplifies any
# difference step over step (two identical plain runs part by ~20% of the
# distance travelled: cuDNN's backward is not bitwise repeatable), so the
# fused run is held to PARAM_TOL times the larger of that gap and the gap
# of a plain run from params nudged by NUDGE (relative, ~ the one-step
# gradient gap between fused and plain).
PARAM_TOL = 3.0
NUDGE = 1e-5


def vgg_fused_check(torch, port, name: str = "VGG11",
                    batch: int = VGG_BATCH, pairs: int = 4,
                    window: int = 20) -> dict:
    """Phase 13: a VGG train step with fused_bn=True against the plain one
    on the same params and batches (torch.backends.cudnn.benchmark off, so
    both pick the same convolution algorithms): the f32 loss bit for bit,
    every weight's gradient within GRAD_TOL of its largest entry and the
    conv biases' within BIAS_GRAD_TOL of the largest gradient entry (each
    beside the gap between two identical plain runs), the params after 10
    SGD steps within PARAM_TOL of the plain runs' own spread,
    K1a/K1b launched once per BN layer on the fused step and never on the
    plain one.  Then alternated bf16 windows of ``window`` steps, fused and
    plain, ``pairs`` of each: median ms/step, device ms/step and idle
    share from one profiled window of each, peak memory."""
    tr, vgg, fb, cifar = (port["train"], port["vgg"], port["fused_bn"],
                          port["cifar10"])
    n_bn = len(vgg_bn_layers(vgg, name, batch))
    ds = cifar._synthetic(batch * 10, seed=5)
    images = torch.as_tensor(ds.images).to(DEVICE).view(10, batch, 32, 32, 3)
    labels = torch.as_tensor(ds.labels).to(DEVICE).long().view(10, batch)
    p0, s0 = vgg.init(0, name, device=DEVICE)

    def fresh():
        return ({k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
                 for k, v in p0.items()},
                {k: {n: t.clone() for n, t in v.items()}
                 for k, v in s0.items()})

    def counts():
        return (fb.bn_relu_bwd_reduce.launches, fb.bn_relu_bwd_apply.launches)

    cfg = tr.TrainConfig(model=name, strategy="none", batch_size=batch)
    gen = torch.Generator(device=DEVICE)

    def grads(fused):
        params, state = fresh()
        gen.manual_seed(tr.augment_seed(cfg.seed, 0))
        c0 = counts()
        loss, _ = tr._loss_fn(params, state, gen, images[0], labels[0],
                              cfg=cfg, fused_bn=fused)
        loss.backward()
        sync(torch)
        c1 = counts()
        return (loss.detach(), {k: p.grad for k, p in
                                vgg.flatten(params).items()},
                (c1[0] - c0[0], c1[1] - c0[1]))

    lp, gp, cp = grads(False)
    lf, gf, cf = grads(True)
    lp2, gp2, _ = grads(False)

    def run10(fused, nudge=0.0):
        params, state = fresh()
        if nudge:
            g = torch.Generator(device=DEVICE).manual_seed(9)
            with torch.no_grad():
                for p in vgg.flatten(params).values():
                    p.mul_(1 + nudge * torch.randn(p.shape, generator=g,
                                                   device=DEVICE))
        opt = tr.make_optimizer(cfg, params)
        step = tr.make_train_step(cfg, fused_bn=fused)
        losses = []
        for i in range(10):
            loss, state, _, _, _ = step(params, state, opt, i, images[i],
                                        labels[i])
            losses.append(loss)
        sync(torch)
        return ({k: p.detach() for k, p in vgg.flatten(params).items()},
                [x.item() for x in losses])

    start = {k: t.detach() for k, t in vgg.flatten(p0).items()}

    def moved_gap(a, b):
        """|a - b| over |b - start|, L2 over every param: how far apart
        two runs ended against how far training moved them."""
        num = sum(((a[k] - b[k]).double() ** 2).sum() for k in b)
        den = sum(((b[k] - start[k]).double() ** 2).sum() for k in b)
        return (num / den).sqrt().item()

    (pf, lsf), (pp, lsp) = run10(True), run10(False)
    (pp2, _), (pn, _) = run10(False), run10(False, nudge=NUDGE)
    gaps, gaps_pp = _grad_gaps(gf, gp), _grad_gaps(gp2, gp)
    res = {"loss_plain": lp.item(), "loss_fused": lf.item(),
           "loss_bitwise": bool(torch.equal(lp, lf)),
           "grad_gap": gaps[0], "grad_gap_plain_vs_plain": gaps_pp[0],
           "bias_grad_gap": gaps[1],
           "bias_grad_gap_plain_vs_plain": gaps_pp[1],
           "losses_10_fused": lsf, "losses_10_plain": lsp,
           "param_gap_10_steps": moved_gap(pf, pp),
           "param_gap_10_steps_plain_vs_plain": moved_gap(pp2, pp),
           "param_gap_10_steps_nudged_plain": moved_gap(pn, pp),
           "param_gap_10_steps_worst_tensor": _rel_gap(pf, pp),
           "launches_fused_step": cf, "launches_plain_step": cp,
           "grad_tol": GRAD_TOL, "bias_grad_tol": BIAS_GRAD_TOL,
           "param_tol": f"{PARAM_TOL} x max(plain vs plain, nudged plain)"}
    param_bound = PARAM_TOL * max(res["param_gap_10_steps_plain_vs_plain"],
                                  res["param_gap_10_steps_nudged_plain"])
    print("  f32 step, fused vs plain: " + json.dumps(res))
    if not res["loss_bitwise"]:
        fail(f"fused and plain f32 losses differ: {lf.item()} vs "
             f"{lp.item()}")
    if not (res["grad_gap"] <= GRAD_TOL
            and res["bias_grad_gap"] <= BIAS_GRAD_TOL):
        fail(f"fused gradients disagree: {res['grad_gap']}, conv biases "
             f"{res['bias_grad_gap']}")
    if not res["param_gap_10_steps"] <= param_bound:
        fail(f"params after 10 steps disagree: {res['param_gap_10_steps']} "
             f"> {param_bound}")
    if cf != (n_bn, n_bn) or cp != (0, 0):
        fail(f"K1a/K1b launches {cf} fused, {cp} plain per step (want "
             f"{n_bn} and 0)")
    del gp, gf, gp2, pf, pp, pp2, pn
    res["bf16"] = fused_plain_windows(torch, port, name, batch, images,
                                      labels, pairs, window)
    torch.cuda.empty_cache()
    return res


def fused_plain_windows(torch, port, name, batch, images, labels, pairs,
                        window) -> dict:
    """Alternated bf16 windows (fused, plain, plain, fused, ...): the host
    slows over a run, so only windows taken in turns compare.  K1a/K1b
    launches are counted from 0 over the fused windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tr, vgg, fb = port["train"], port["vgg"], port["fused_bn"]
    cfg = tr.TrainConfig(model=name, strategy="none", batch_size=batch,
                         compute_dtype="bfloat16")
    runs = {}
    for fused in (True, False):
        p0, s0 = vgg.init(0, name, device=DEVICE)
        params = {k: {n: t.requires_grad_(True) for n, t in v.items()}
                  for k, v in p0.items()}
        runs[fused] = {"params": params, "state": s0,
                       "opt": tr.make_optimizer(cfg, params),
                       "step": tr.make_train_step(cfg, fused_bn=fused),
                       "i": 0, "ms": [], "peak_gb": [], "losses": []}

    def steps(r, k):
        for _ in range(k):
            j = r["i"] % images.shape[0]
            loss, r["state"], _, _, _ = r["step"](
                r["params"], r["state"], r["opt"], r["i"], images[j],
                labels[j])
            r["losses"].append(loss)
            r["i"] += 1

    for r in runs.values():
        steps(r, 3)  # warm-up: allocator, cuDNN handles
    fb.bn_relu_bwd_reduce.launches = fb.bn_relu_bwd_apply.launches = 0
    copies0 = fb.bn_relu_bwd.copies
    order = [True, False, False, True] * ((pairs + 1) // 2)
    for fused in order[: 2 * pairs]:
        r = runs[fused]
        plain_before = (fb.bn_relu_bwd_reduce.launches,
                        fb.bn_relu_bwd_apply.launches)
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        steps(r, window)
        sync(torch)
        r["ms"].append((time.perf_counter() - t0) / window * 1e3)
        r["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
        if not fused and (fb.bn_relu_bwd_reduce.launches,
                          fb.bn_relu_bwd_apply.launches) != plain_before:
            fail("K1a/K1b launched on the plain path")
    launches = {"K1a": fb.bn_relu_bwd_reduce.launches,
                "K1b": fb.bn_relu_bwd_apply.launches}
    # layout copies bn_relu_bwd had to make of autograd's dr or of a
    out = {"window_steps": window, "pairs": pairs, "launches": launches,
           "layout_copies": fb.bn_relu_bwd.copies - copies0}
    for fused, r in runs.items():
        prof = profile(activities=[ProfilerActivity.CUDA])
        sync(torch)
        with prof:
            steps(r, 5)
            sync(torch)
        device_us, n_ops, top = 0.0, 0, {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                device_us += e.self_device_time_total
                n_ops += e.count
                top[e.key] = top.get(e.key, 0.0) + e.self_device_time_total
        med = float(np.median(r["ms"]))
        losses = [float(x) for x in r["losses"]]
        out["fused" if fused else "plain"] = {
            "ms_per_step_windows": r["ms"], "ms_per_step_median": med,
            "device_ms_per_step": device_us / 1e3 / 5,
            "device_ops_per_step": n_ops / 5,
            "device_idle_share": 1.0 - device_us / 1e3 / 5 / med,
            "peak_mem_gb": max(r["peak_gb"]),
            "losses_first_last": [losses[0], losses[-1]],
            "top_kernels": [[k[:60], us / max(device_us, 1e-9)] for k, us in
                            sorted(top.items(), key=lambda kv: -kv[1])[:8]]}
        if not all(np.isfinite(losses)):
            fail(f"bf16 {'fused' if fused else 'plain'} losses not finite")
    want = len(vgg_bn_layers(port["vgg"], name, batch)) * window * pairs
    if launches != {"K1a": want, "K1b": want}:
        fail(f"K1a/K1b launches over the fused windows {launches}, want "
             f"{want} each")
    out["fused_over_plain_ms"] = (out["fused"]["ms_per_step_median"]
                                  / out["plain"]["ms_per_step_median"])
    print("  bf16 windows, fused vs plain, alternated: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("fused", "plain")}))
    for k in ("fused", "plain"):
        print(f"  bf16 {k}: " + json.dumps(out[k]))
    return out


def vgg_cli_run(torch, port, extra: list[str], label: str,
                batch: int = VGG_BATCH, model: str = "VGG11",
                profile_at: int = 170, strategy: str | None = "none"
                ) -> dict:
    """Phase 14: one epoch of synthetic CIFAR-10 through the port's
    ``cli.run`` (``strategy`` "none" is the reference's main.py; None
    leaves the CLI's default, ddp over a one-rank NCCL group, which
    ``cli.run`` destroys when it returns), then its test evaluation.  ms/step and samples/s come from the reference's 40-step
    time windows; 5 steps after the last window run under torch.profiler
    for device time, operations per step and the idle share; mfu is
    bench.py's 916.6 MFLOP per sample times samples/s over the card's peak
    for the compute dtype (bf16: 989 TFLOP/s dense; float32 with TF32 off,
    as phase 1 sets it: the 67 TFLOP/s non-tensor peak)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cli, fb = port["cli"], port["fused_bn"]
    prof = profile(activities=[ProfilerActivity.CUDA])
    marks = {}

    def on_step(step):
        if step in (profile_at, profile_at + 5):
            sync(torch)
            marks[step] = time.perf_counter()
            (prof.start if step == profile_at else prof.stop)()

    argv = (["--strategy", strategy] if strategy else []) + [
        "--epochs", "1", "--batch-size", str(batch), "--model", model,
        "--device", DEVICE] + extra
    k1 = (fb.bn_relu_bwd_reduce.launches, fb.bn_relu_bwd_apply.launches)
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = cli.run(argv, on_step=on_step)
    wall = time.perf_counter() - t0
    (ep,) = out["epochs"]
    windows = [r.value * 1e3 for r in ep["time_meter"].records]
    loss_windows = [r.value for r in ep["loss_meter"].records]
    device_us, n_ops, top, counts = 0.0, 0, {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            device_us += e.self_device_time_total
            n_ops += e.count
            top[e.key] = top.get(e.key, 0.0) + e.self_device_time_total
            counts[e.key] = counts.get(e.key, 0) + e.count
    ms = float(np.median(windows))
    sps = batch / (ms / 1e3)
    dtype = "bfloat16" if "bfloat16" in extra else "float32"
    flops = vgg11_train_flops_per_sample() if model == "VGG11" else None
    res = {"label": label, "steps": out["trainer"]._step, "batch": batch,
           "strategy": out["trainer"].strategy.name,
           "process_group_left": torch.distributed.is_initialized(),
           "synthetic": out["synthetic"],
           "ms_per_step_windows": windows, "ms_per_step": ms,
           "samples_per_s": sps,
           "mfu": None if flops is None else flops * sps / PEAK_OPS[dtype],
           "mfu_peak_tflops": PEAK_OPS[dtype] / 1e12,
           "device_ms_per_step": device_us / 1e3 / 5,
           "device_ops_per_step": n_ops / 5,
           "device_idle_share": 1.0 - device_us / 1e3 / 5 / ms,
           "profiled_wall_ms_per_step": (marks[profile_at + 5]
                                         - marks[profile_at]) / 5 * 1e3
           if len(marks) == 2 else None,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_first_window": loss_windows[0],
           "loss_last_window": loss_windows[-1],
           "test_loss": ep["eval"][0], "test_accuracy": ep["eval"][1],
           "wall_s": wall,
           "k1_launches": (fb.bn_relu_bwd_reduce.launches - k1[0],
                           fb.bn_relu_bwd_apply.launches - k1[1]),
           "top_kernels": [[k[:60], us / max(device_us, 1e-9)] for k, us in
                           sorted(top.items(), key=lambda kv: -kv[1])[:8]]}
    print(f"  {label}: " + json.dumps(res))
    if not all(np.isfinite(loss_windows)) or len(marks) != 2:
        fail(f"{label}: loss windows {loss_windows}, profile marks {marks}")
    if not loss_windows[-1] < loss_windows[0]:
        fail(f"{label}: the loss did not fall: {loss_windows}")
    if not ep["eval"][1] > 0.1:
        fail(f"{label}: test accuracy {ep['eval'][1]} is not above chance")
    if res["process_group_left"]:
        fail(f"{label}: the cli left its process group behind")
    del out
    torch.cuda.empty_cache()
    return res

# -- phases 15-17: int8 LM training, remat and the chunked head ------------

# K5 at LM-base training (B=8 x S=1024 tokens): (m, k, n) -> launches per
# layer (q, k, v, o; gate, up; down)
K5_SHAPES = {(8192, 1024, 1024): 4, (8192, 1024, 4096): 2,
             (8192, 4096, 1024): 1}


def int8_operands(torch, m, k, n, dtype, seed):
    """x (m, k), w (k, n) on the card: a zero row (scale 1e-30) and a row
    whose extremes quantize to -127 and +127."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), np.float32)
    w = rng.standard_normal((k, n), np.float32) / math.sqrt(k)
    x[1] = 0.0
    x[2, :3] = (-5.0, 5.0, 2.5)
    return (torch.from_numpy(x).to(DEVICE, dtype),
            torch.from_numpy(w).to(DEVICE, dtype))


K5_OUT = {"f32": "float32", "bf16": "bfloat16"}  # K5's output dtypes


def k5_routes(qz) -> dict:
    """A copy of K5's launches per route so far."""
    return dict(qz.int8_matmul_q.route_launches)


def k5_route_of(qz, before: dict) -> str:
    """The route of the one K5 launch since ``before``."""
    now = k5_routes(qz)
    taken = [r for r in now if now[r] != before[r]]
    if len(taken) != 1 or now[taken[0]] != before[taken[0]] + 1:
        fail(f"K5: want one launch since {before}, got {now}")
    return taken[0]


def int8_build_report(build, facts) -> list[dict]:
    """K5's sm90 instances (int8_matmul_sm90_kernel, float32 and bf16
    output) as ptxas built them: registers at launch, spills, stack,
    static and dynamic shared memory; fails on a spill or a stack frame."""
    lib = build.load_library("int8_matmul")
    rep = ptxas_report(build.build_info["int8_matmul"]["log"],
                       "int8_matmul_sm90_kernel")
    if len(rep) != 2:
        fail(f"ptxas reported {len(rep)} int8_matmul_sm90_kernel instances, "
             f"want 2")
    for r in rep:
        r["out"] = "bf16" if "bfloat16" in r["function"] else "f32"
        r["dynamic_smem_bytes"] = lib.int8_matmul_sm90_smem()
        print(f"  K5 sm90 ({r['out']} out): "
              f"{r.get('registers')} registers at launch, "
              f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes "
              f"spilled (stores / loads), {r.get('stack_bytes')} bytes "
              f"stack, {r['static_smem_bytes']} + {r['dynamic_smem_bytes']} "
              f"bytes shared memory (static + dynamic); {facts['smi']}")
        if r.get("spill_stores") or r.get("spill_loads") \
                or r.get("stack_bytes") or "spill_stores" not in r:
            fail(f"int8_matmul_sm90_kernel spills, keeps a stack frame (its "
                 f"accumulators in local memory) or was not reported: {r}")
    return rep


def check_int8_kernel(torch, qz) -> dict:
    """K5 against int8_matmul_plain on the card, in float32 and bf16
    output: the three LM-base shapes (bf16 and f32 inputs; each through
    the sm90 route the plan picks and through the mma_sync route asked
    for), 33 x 77 @ 77 x 19, m = 8191, k = 1000 (not a multiple of 16:
    the mma_sync route's byte-wise loads), n = 4100 (its bf16 rows are not
    whole 16-byte units: the mma_sync route), k = 1040 (a k tail in the
    sm90 route's last 128-byte slice); bitwise in every case, two runs
    bitwise equal, the zero row exactly 0; then 52 back-to-back launches
    at two shapes, all bitwise equal to the first (the persistent walk and
    the ring's phase bits over many launches)."""
    cases = [(m, k, n, dt) for (m, k, n) in K5_SHAPES
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(33, 77, 19, torch.float32), (33, 77, 19, torch.bfloat16),
              (8191, 1024, 1024, torch.bfloat16),
              (1024, 1000, 1024, torch.bfloat16),
              (1024, 1024, 4100, torch.float32),
              (1000, 1040, 1032, torch.bfloat16)]
    worst, routes_seen = 0.0, {}
    for i, (m, k, n, dt) in enumerate(cases):
        x, w = int8_operands(torch, m, k, n, dt, 200 + i)
        qx, sx = qz.quantize_rowwise(x)
        qwt, sw = qz.quantize_rowwise(w.t())
        qwt = qwt.contiguous()
        asked = [None] + (["mma_sync"] if (m, k, n) in K5_SHAPES else [])
        for out in K5_OUT:
            odt = getattr(torch, K5_OUT[out])
            ref = qz.int8_matmul_plain(x, w, odt)
            for route in asked:
                before = k5_routes(qz)
                if route is None:
                    got = qz.int8_matmul(x, w, out_dtype=odt)
                else:
                    got = qz.int8_matmul_q(qx, qwt, sx, sw, odt, route=route)
                took = k5_route_of(qz, before)
                again = qz.int8_matmul_q(qx, qwt, sx, sw, odt, route=took)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                ok = (got.dtype == odt, torch.equal(got, ref),
                      torch.equal(got, again), not bool(got[1].any()),
                      bool(torch.isfinite(got).all()))
                print(f"  {str(dt)[6:]:8s} m={m:5d} k={k:5d} n={n:5d} "
                      f"{out:4s} out, {took:8s} route: max|K5 - plain| "
                      f"{err:.3e}, bitwise {ok[1]}, repeat bitwise {ok[2]}, "
                      f"zero row {ok[3]}")
                if not all(ok):
                    fail(f"K5 disagrees with int8_matmul_plain (dtype, "
                         f"bitwise, repeat, zero row, finite = {ok}) at "
                         f"m={m} k={k} n={n} {dt}, {out} out, {took} route")
                if route is None:
                    routes_seen[f"{m}x{k}x{n} {out}"] = took
                worst = max(worst, err)
            del ref
    want = {f"{m}x{k}x{n} {out}": "sm90" for m, k, n in K5_SHAPES
            for out in K5_OUT}
    want.update({"1024x1000x1024 f32": "mma_sync",
                 "1024x1024x4100 bf16": "mma_sync"})
    for shape, route in want.items():
        if routes_seen[shape] != route:
            fail(f"K5 took the {routes_seen[shape]} route at {shape}, want "
                 f"{route}")
    print(f"  K5 bitwise equal to its plain version in all {len(cases)} "
          f"cases, each in f32 and bf16 output; routes: "
          + json.dumps(routes_seen))
    n_rep = 52
    for (m, k, n), out in (((8192, 1024, 4096), "bf16"),
                           ((8191, 1024, 1024), "f32")):
        x, w = int8_operands(torch, m, k, n, torch.bfloat16, 77)
        qx, sx = qz.quantize_rowwise(x)
        qwt, sw = qz.quantize_rowwise(w.t())
        qwt = qwt.contiguous()
        odt = getattr(torch, K5_OUT[out])
        before = k5_routes(qz)
        outs = [qz.int8_matmul_q(qx, qwt, sx, sw, odt) for _ in range(n_rep)]
        torch.cuda.synchronize()
        ref = qz.int8_matmul_plain(x, w, odt)
        same = sum(torch.equal(o, ref) for o in outs)
        routes = {r: v - before[r] for r, v in k5_routes(qz).items()}
        print(f"  {n_rep} back-to-back launches at m={m} k={k} n={n} ({out} "
              f"out, routes {routes}): {same} bitwise equal to the plain "
              f"version")
        if same != n_rep or routes["sm90"] != n_rep:
            fail(f"K5 back-to-back launches: {same} of {n_rep} bitwise, "
                 f"routes {routes}")
        del outs, ref
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "cases": len(cases), "routes": routes_seen}


def int8_bounds(facts, m, k, n) -> dict:
    """K5's bound at (m, k, n) per output dtype: max(2 m n k over 1,979
    int8 TOP/s, (m k + n k + 4 (m + n) + out_bytes m n) over the memory
    rate), in ms, and which of the two sets it."""
    ops = 2 * m * n * k
    to = ops / PEAK_OPS["int8"] * 1e3
    res = {"ops": ops}
    for out, nb in (("f32", 4), ("bf16", 2)):
        nbytes = m * k + k * n + 4 * (m + n) + nb * m * n
        tb = nbytes / facts["bw"] * 1e3
        res[out] = {"bytes": nbytes, "bound_ms": max(tb, to),
                    "bound_by": "bytes" if tb >= to else "operations"}
    return res


def time_int8(torch, qz, facts) -> dict:
    """K5 at the three LM-base shapes on quantized bf16 operands, device ms
    by CUDA events with the operands rotated past the 50 MB L2: the sm90
    route (the plan's) against the mma_sync route in alternated windows
    (sm90, mma_sync, mma_sync, sm90) for each output dtype; the bound of
    each output dtype (int8_bounds); the plain version of the kernel's
    work (the float64 integer product and the epilogue); torch._int_mm
    (cuBLASLt's int8 product, int32 out) alone, and with the epilogue
    (and the bf16 cast) as the library yardstick, which the port never
    calls.  Also the per-layer sums (7 launches)."""
    out = {}
    for (m, k, n) in K5_SHAPES:
        x, w = int8_operands(torch, m, k, n, torch.bfloat16, 7)
        qx, sx = qz.quantize_rowwise(x)
        qwt, sw = qz.quantize_rowwise(w.t())
        qwt = qwt.contiguous()
        per = qx.numel() + qwt.numel() + 4 * m * n
        n_rot = max(2, math.ceil(200e6 / per))
        sets = [(qx.clone(), qwt.clone(), sx.clone(), sw.clone())
                for _ in range(n_rot)]
        del x, w
        it = iter(range(10 ** 9))

        def k5(o, route):
            odt = getattr(torch, K5_OUT[o])
            return lambda: qz.int8_matmul_q(*sets[next(it) % n_rot], odt,
                                            route=route)

        def plain():
            a, b, c, d = sets[next(it) % n_rot]
            qz._dequant(qz._int_product(a, b.t()), c, d.view(1, -1))

        def int_mm():
            a, b, c, d = sets[next(it) % n_rot]
            torch._int_mm(a, b.t())

        def library(o):
            def run():
                a, b, c, d = sets[next(it) % n_rot]
                y = torch._int_mm(a, b.t()).float() * (c * d.view(1, -1))
                if o == "bf16":
                    y.to(torch.bfloat16)
            return run

        res = {"bounds": int8_bounds(facts, m, k, n), "launches_per_layer":
               K5_SHAPES[(m, k, n)]}
        counts = (qz.int8_matmul_q.launches, k5_routes(qz))
        for o in K5_OUT:
            w_ = {"sm90": [], "mma_sync": []}
            for route in ("sm90", "mma_sync", "mma_sync", "sm90"):
                w_[route].append(time_ms(torch, k5(o, route)))
            ratios = [a / b for a, b in zip(w_["sm90"], w_["mma_sync"])]
            res[o] = {"ms": float(np.mean(w_["sm90"])),
                      "mma_sync_ms": float(np.mean(w_["mma_sync"])),
                      "ms_windows": w_["sm90"],
                      "mma_sync_ms_windows": w_["mma_sync"],
                      "sm90_over_mma_sync": float(np.mean(ratios)),
                      "library_ms": time_ms(torch, library(o))}
            b = res["bounds"][o]
            res[o]["bound_share"] = b["bound_ms"] / res[o]["ms"]
            res[o]["tops"] = res["bounds"]["ops"] / res[o]["ms"] / 1e9
        # timing launches are not counted
        qz.int8_matmul_q.launches = counts[0]
        qz.int8_matmul_q.route_launches = counts[1]
        res["int_mm_ms"] = time_ms(torch, int_mm)
        res["plain_ms"] = time_ms(torch, plain, iters=5)
        out[(m, k, n)] = res
        print(f"  K5 m={m} k={k} n={n}: " + json.dumps(res))
        del sets
    layer = {}
    for o in K5_OUT:
        layer[o] = {key: sum(cnt * out[s][o][key]
                             for s, cnt in K5_SHAPES.items())
                    for key in ("ms", "mma_sync_ms", "library_ms")}
        layer[o]["bound_ms"] = sum(cnt * out[s]["bounds"][o]["bound_ms"]
                                   for s, cnt in K5_SHAPES.items())
        by_bytes = sum(cnt * out[s]["bounds"][o]["bound_ms"]
                       for s, cnt in K5_SHAPES.items()
                       if out[s]["bounds"][o]["bound_by"] == "bytes")
        layer[o]["bound_by"] = ("bytes" if by_bytes >= layer[o]["bound_ms"]
                                / 2 else "operations")
        layer[o]["bound_share"] = layer[o]["bound_ms"] / layer[o]["ms"]
    for key in ("int_mm_ms", "plain_ms"):
        layer[key] = sum(cnt * out[s][key] for s, cnt in K5_SHAPES.items())
    print("  K5 per layer (7 launches): " + json.dumps(layer) + "; "
          + facts["smi"])
    torch.cuda.empty_cache()
    return {"shapes": {f"{m}x{k}x{n}": v for (m, k, n), v in out.items()},
            "per_layer": layer}


def lm_base_bytes(port):
    """LM-base with lm_cli's byte vocabulary, as phase 8 trains it."""
    import dataclasses
    return dataclasses.replace(port["tfm"].PRESETS["LM-base"],
                               vocab_size=port["corpus"].VOCAB_SIZE)


def int8_bf16_windows(torch, port, pairs: int = 4, window: int = 10
                      ) -> dict:
    """Alternated LM-base bf16 training windows, int8 matmul and plain
    (int8, bf16, bf16, int8, ...: the host drifts over a run, so only
    windows taken in turns compare), two trainers from the same seed on
    the same batches; then the teacher-forced argmax flip rate of the int8
    forward against the bf16 one on the bf16 run's params and a held-out
    batch (reported, not gated: the JAX package's 0.02 ceiling is for a
    trained model)."""
    lm, tfm, corpus_mod = port["lm"], port["tfm"], port["corpus"]
    model = lm_base_bytes(port)
    corpus = corpus_mod.load_corpus(None)
    split = int(len(corpus) * 0.9)
    train = corpus_mod.LMCorpus(corpus.tokens[:split], corpus.synthetic)
    loader = corpus_mod.LMDataLoader(train, 8, 1024, seed=1)
    batches = [bt for _, bt in zip(range(window), loader)]
    runs = {}
    for mode in ("int8", "bf16"):
        cfg = lm.LMTrainConfig(model=model, compute_dtype="bfloat16",
                               matmul_dtype="int8" if mode == "int8"
                               else None)
        tr = lm.LMTrainer(cfg, device=DEVICE)
        for tk, tg in batches[:2]:  # warm-up
            tr.train_step(tk, tg)
        runs[mode] = {"tr": tr, "ms": []}
    order = ["int8", "bf16", "bf16", "int8"] * ((pairs + 1) // 2)
    for mode in order[: 2 * pairs]:
        tr = runs[mode]["tr"]
        sync(torch)
        t0 = time.perf_counter()
        for tk, tg in batches:
            loss = tr.train_step(tk, tg)
        float(loss)
        sync(torch)
        runs[mode]["ms"].append((time.perf_counter() - t0) / window * 1e3)
    held = corpus_mod.LMCorpus(corpus.tokens[split:], corpus.synthetic)
    tk, _ = next(iter(corpus_mod.LMDataLoader(held, 8, 1024,
                                              shuffle=False)))
    params = {n: p.detach() for n, p in runs["bf16"]["tr"].params.items()}
    with torch.no_grad():
        tk = torch.as_tensor(tk, device=DEVICE).long()
        a = tfm.apply(params, tk, cfg=model, dtype=torch.bfloat16)
        b = tfm.apply(params, tk, cfg=model, dtype=torch.bfloat16,
                      matmul_dtype="int8")
        flips = (a.argmax(-1) != b.argmax(-1)).float().mean().item()
    med = {m: float(np.median(r["ms"])) for m, r in runs.items()}
    res = {"window_steps": window, "pairs": pairs,
           "int8_ms_windows": runs["int8"]["ms"],
           "bf16_ms_windows": runs["bf16"]["ms"],
           "int8_ms_median": med["int8"], "bf16_ms_median": med["bf16"],
           "int8_over_bf16_ms": med["int8"] / med["bf16"],
           "argmax_flip_rate_int8_vs_bf16": flips,
           "flip_rate_tokens": int(a.shape[0] * a.shape[1])}
    print("  alternated int8/bf16 windows: " + json.dumps(res))
    del runs, params, a, b
    torch.cuda.empty_cache()
    return res


def int8_step_check(torch, port) -> dict:
    """One LM-base-width float32 int8 step (2 layers, B=2, S=512): loss and
    gradients through K5 twice, then through the plain int8 product (the
    module's int8_matmul swapped for int8_matmul_plain for this comparison
    only).  The loss must be bitwise equal; the gradients equal, or no
    further apart than the two kernel runs."""
    import dataclasses
    tfm, lm, qz = port["tfm"], port["lm"], port["qz"]
    model = dataclasses.replace(tfm.PRESETS["LM-base"], n_layers=2)
    cfg = lm.LMTrainConfig(model=model, compute_dtype=None,
                           matmul_dtype="int8")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, model.vocab_size, (2, 512)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1).astype(np.int32)
    targets[:, -1] = lm.IGNORE
    tr = lm.LMTrainer(cfg, device=DEVICE)
    tk, tg = tr._batch(tokens, targets)
    n_total = (tg != lm.IGNORE).sum().float()

    def loss_and_grads():
        for p in tr.params.values():
            p.grad = None
        loss = lm._loss_fn(cfg, "flash", tr.params, tk, tg, n_total, 0.0)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in
                             tr.params.items()}

    n0 = qz.int8_matmul_q.launches
    k1, k2 = loss_and_grads(), loss_and_grads()
    launched = qz.int8_matmul_q.launches - n0
    kernel = qz.int8_matmul
    qz.int8_matmul = qz.int8_matmul_plain
    try:
        pl = loss_and_grads()
    finally:
        qz.int8_matmul = kernel

    def gap(a, b):
        return max(((a[n] - b[n]).abs().max() / b[n].abs().max()
                    .clamp_min(1e-30)).item() for n in a)

    res = {"loss_kernel": k1[0], "loss_plain": pl[0],
           "loss_bitwise": k1[0] == pl[0] == k2[0],
           "grad_rel_gap_kernel_plain": gap(k1[1], pl[1]),
           "grad_rel_gap_kernel_kernel": gap(k1[1], k2[1]),
           "k5_launches_two_steps": launched}
    print("  f32 int8 step, K5 vs plain: " + json.dumps(res))
    if not res["loss_bitwise"]:
        fail(f"the int8 loss through K5 is not bitwise the plain one's: "
             f"{res}")
    if res["grad_rel_gap_kernel_plain"] > res["grad_rel_gap_kernel_kernel"]:
        fail(f"int8 gradients through K5 and the plain product differ "
             f"more than two K5 runs: {res}")
    if launched != 2 * 7 * model.n_layers:
        fail(f"K5 launched {launched} times in two 2-layer forwards")
    del tr
    torch.cuda.empty_cache()
    return res


REMAT_GNORM_TOL = 1e-3  # bf16 gradients summed in another order


def remat_runs(torch, port, steps: int = 3) -> dict:
    """LM-base bf16 through lm_cli with --remat none, full and selective,
    3 steps each from the same seed and batches: step-1 losses bitwise
    equal (the same forward), step-1 grad-norms within REMAT_GNORM_TOL
    relative; the peak memory of the run (the optimizer's transients
    included), ms per step over steps 2-3, and the peak of one forward +
    backward above the trainer's resident params and Adam state (the
    activations and the gradients: what remat changes); K2 launched twice
    per layer per step under full remat (the recompute) and once under
    selective (the kept (o, lse)), K3/K4 once."""
    attn, cli, lm = port["attn"], port["lm_cli"], port["lm"]
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, port["corpus"].VOCAB_SIZE, (8, 1024))
    targets = np.roll(tokens, -1, axis=1)
    out = {}
    for mode in ("none", "full", "selective"):
        losses, gnorms, t = [], [], {}

        def on_step(step, trainer, loss):
            losses.append(loss)
            gnorms.append(trainer.last_metrics[0])
            if step in (1, steps):
                sync(torch)
                t[step] = time.perf_counter()

        for f in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            getattr(attn, f).launches = 0
        argv = ["--preset", "LM-base", "--steps", str(steps),
                "--batch-size", "8", "--seq-len", "1024", "--compute-dtype",
                "bfloat16", "--log-every", "1000", "--device", DEVICE,
                "--remat", mode]
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = cli.run(argv, on_step=on_step)
        sync(torch)
        out[mode] = {
            "losses": [float(x) for x in losses],
            "grad_norms": [float(x) for x in gnorms],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "ms_per_step_2_to_last": (t[steps] - t[1]) / (steps - 1) * 1e3,
            "s": time.perf_counter() - t0,
            "launches": {"K2": attn.flash_attention_fwd.launches,
                         "K3": attn.flash_attention_bwd_dq.launches,
                         "K4": attn.flash_attention_bwd_dkv.launches}}
        n_layers = trainer.cfg.model.n_layers
        tk, tg = trainer._batch(tokens, targets)
        for p in trainer.params.values():
            p.grad = None
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        lm._loss_fn(trainer.cfg, "flash", trainer.params, tk, tg,
                    (tg != lm.IGNORE).sum().float(), 0.0).backward()
        sync(torch)
        out[mode]["fwd_bwd_peak_gb"] = \
            (torch.cuda.max_memory_allocated() - base) / 1e9
        del trainer
        torch.cuda.empty_cache()
        print(f"  remat {mode}: " + json.dumps(out[mode]))
    ref = out["none"]
    for mode in ("full", "selective"):
        r = out[mode]
        if r["losses"][0] != ref["losses"][0]:
            fail(f"remat {mode}: step-1 loss {r['losses'][0]} is not the "
                 f"no-remat {ref['losses'][0]}")
        rel = abs(r["grad_norms"][0] - ref["grad_norms"][0]) \
            / ref["grad_norms"][0]
        r["grad_norm_rel_diff_step1"] = rel
        if not rel <= REMAT_GNORM_TOL:
            fail(f"remat {mode}: step-1 grad-norm {rel} relative from "
                 f"the no-remat step")
    for mode, k2 in (("none", 1), ("full", 2), ("selective", 1)):
        want = {"K2": k2, "K3": 1, "K4": 1}
        for k, n in out[mode]["launches"].items():
            if n != want[k] * n_layers * steps:
                fail(f"remat {mode}: {k} launched {n} times, want "
                     f"{want[k]} x {n_layers} layers x {steps} steps")
    return out


def remat_windows(torch, port, pairs: int = 4, window: int = 5) -> dict:
    """--remat full against --remat selective on LM-base bf16 (B=8 x 1024):
    two trainers from one seed on the same batches, timed in alternated
    windows of ``window`` steps (full, selective, selective, full, ...),
    K2's launches counted in each window (2 per layer per step under full
    remat, the recompute; 1 under selective, the kept (o, lse)), then one
    profiled step of each: device ms and operations, by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lm, corpus_mod, attn = port["lm"], port["corpus"], port["attn"]
    model = lm_base_bytes(port)
    loader = corpus_mod.LMDataLoader(corpus_mod.load_corpus(None), 8, 1024,
                                     seed=1)
    batches = [bt for _, bt in zip(range(window), loader)]
    runs = {}
    for mode in ("full", "selective"):
        cfg = lm.LMTrainConfig(model=model, compute_dtype="bfloat16",
                               remat=mode)
        tr = lm.LMTrainer(cfg, device=DEVICE)
        for tk, tg in batches[:2]:  # warm-up
            tr.train_step(tk, tg)
        runs[mode] = {"tr": tr, "ms": [], "K2": []}
    order = ["full", "selective", "selective", "full"] * ((pairs + 1) // 2)
    for mode in order[: 2 * pairs]:
        tr = runs[mode]["tr"]
        attn.flash_attention_fwd.launches = 0
        sync(torch)
        t0 = time.perf_counter()
        for tk, tg in batches:
            loss = tr.train_step(tk, tg)
        float(loss)
        sync(torch)
        runs[mode]["ms"].append((time.perf_counter() - t0) / window * 1e3)
        runs[mode]["K2"].append(attn.flash_attention_fwd.launches)
    res = {"window_steps": window, "pairs": pairs}
    for mode, r in runs.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            r["tr"].train_step(*batches[0])
            sync(torch)
        dev = {}
        n_ops = 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                dev[e.key] = dev.get(e.key, 0.0) + e.self_device_time_total
                n_ops += e.count
        total = sum(dev.values())
        res[mode] = {"ms_windows": r["ms"],
                     "ms_median": float(np.median(r["ms"])),
                     "K2_launches_per_window": r["K2"],
                     "profiled_step_device_ms": total / 1e3,
                     "profiled_step_device_ops": n_ops,
                     "profiled_step_top_kernels": [
                         [k[:60], us / 1e3] for k, us in sorted(
                             dev.items(), key=lambda kv: -kv[1])[:6]]}
    res["selective_over_full_ms"] = res["selective"]["ms_median"] \
        / res["full"]["ms_median"]
    print("  remat full vs selective, alternated windows: "
          + json.dumps(res))
    n_layers = model.n_layers
    for mode, per_layer in (("full", 2), ("selective", 1)):
        if any(n != per_layer * n_layers * window
               for n in res[mode]["K2_launches_per_window"]):
            fail(f"remat {mode}: K2 launches per window "
                 f"{res[mode]['K2_launches_per_window']}, want "
                 f"{per_layer} x {n_layers} layers x {window} steps")
    del runs
    torch.cuda.empty_cache()
    return res


HEAD_TOL = {"loss_rel": 1e-5, "dh_rel": 2.0 ** -7, "demb_of_max": 1e-4}


def chunked_head_check(torch, port) -> dict:
    """head_loss dense against chunked at the LM-base preset's vocabulary
    (32,000 rows, the default chunk 1,000), B=8 x S=1024 x 1024, hidden
    states bf16, embedding f32, with ignored targets: loss, gradients,
    time and the peak memory of forward + backward above the inputs.
    Tolerances: loss 1e-5 relative; dh (bf16) one bf16 ulp of each value
    plus 1e-6 of the largest (two float32 sums in different orders, each
    rounded to bf16); dembed 1e-4 of its largest (8,192-term float32 sums,
    chunk by chunk)."""
    losses = port["losses"]
    b, s, d, v = 8, 1024, 1024, port["tfm"].PRESETS["LM-base"].vocab_size
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    h = torch.randn((b, s, d), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    emb = torch.randn((v, d), generator=gen, device=DEVICE) * 0.02
    tg = torch.randint(0, v, (b, s), generator=gen, device=DEVICE)
    tg[:, -1] = port["lm"].IGNORE
    tg[0, :100] = port["lm"].IGNORE
    res = {}
    for impl in ("dense", "chunked"):
        for rep in range(2):  # the second run is timed and measured
            hh = h.clone().requires_grad_(True)
            ee = emb.clone().requires_grad_(True)
            sync(torch)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            ce, n = losses.head_loss(hh, ee, tg, loss_impl=impl)
            loss = ce / n
            loss.backward()
            sync(torch)
            res[impl] = {"loss": loss.item(),
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "peak_above_inputs_gb":
                             (torch.cuda.max_memory_allocated() - base) / 1e9,
                         "dh": hh.grad, "demb": ee.grad}
    dn, ck = res["dense"], res["chunked"]
    loss_rel = abs(ck["loss"] - dn["loss"]) / abs(dn["loss"])
    dh_ok = ((ck["dh"].float() - dn["dh"].float()).abs()
             <= HEAD_TOL["dh_rel"] * dn["dh"].float().abs()
             + 1e-6 * dn["dh"].float().abs().max()).all().item()
    demb_gap = ((ck["demb"] - dn["demb"]).abs().max()
                / dn["demb"].abs().max()).item()
    out = {"vocab": v, "chunk": losses.default_chunk(v),
           "loss_dense": dn["loss"], "loss_chunked": ck["loss"],
           "loss_rel_diff": loss_rel, "dh_within_tol": dh_ok,
           "demb_gap_of_max": demb_gap,
           "dh_max_abs_diff": (ck["dh"].float() - dn["dh"].float()).abs()
           .max().item(),
           "ms_dense": dn["ms"], "ms_chunked": ck["ms"],
           "peak_gb_dense": dn["peak_above_inputs_gb"],
           "peak_gb_chunked": ck["peak_above_inputs_gb"],
           "tolerance": HEAD_TOL}
    print(f"  head_loss dense vs chunked, V={v}: " + json.dumps(out))
    if not (loss_rel <= HEAD_TOL["loss_rel"] and dh_ok
            and demb_gap <= HEAD_TOL["demb_of_max"]):
        fail(f"chunked head disagrees with the dense one: {out}")
    del res, h, emb
    torch.cuda.empty_cache()
    return out


SM90_KERNELS = {"K2": "fwd_sm90_kernel", "K3": "bwd_dq_sm90_kernel",
                "K4": "bwd_dkv_sm90_kernel"}


def sm90_build_report(build, facts) -> dict:
    """The bf16 flash kernels (K2 fwd_sm90_kernel, K3 bwd_dq_sm90_kernel,
    K4 bwd_dkv_sm90_kernel) as ptxas built them, per head dim: registers
    at launch, spills, stack and shared memory (static from ptxas, dynamic
    from the library); fails on any spill."""
    lib = build.load_library("flash_attention")
    log = build.build_info["flash_attention"]["log"]
    out = {}
    for which, (name, fn) in enumerate(SM90_KERNELS.items()):
        rep = ptxas_report(log, fn)
        if len(rep) != 2:
            fail(f"ptxas reported {len(rep)} {fn} instances, want 2")
        for r in rep:
            r["dynamic_smem_bytes"] = lib.flash_sm90_smem(
                which, r["template_int"])
            print(f"  {name} bf16 ({fn}, D={r['template_int']}): "
                  f"{r.get('registers')} registers at launch, "
                  f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes "
                  f"spilled (stores / loads), {r.get('stack_bytes')} bytes "
                  f"stack, {r['static_smem_bytes']} + "
                  f"{r['dynamic_smem_bytes']} bytes shared memory (static "
                  f"+ dynamic); {facts['smi']}")
            if r.get("spill_stores") or r.get("spill_loads") \
                    or "spill_stores" not in r:
                fail(f"{fn} spills or was not reported: {r}")
        out[name] = rep
    return out


def bn_build_report(build, facts) -> list[dict]:
    """Every fused_bn.cu instance (K1a reduce_kernel, K1b apply_kernel x
    float32 / bf16 x 16-byte vectors or one channel) as ptxas built it:
    registers, spills, stack, static shared memory, and the resident
    blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
    Fails on a spill in the instances VGG-11's shapes launch (16-byte
    vectors)."""
    lib = build.load_library("fused_bn")
    log = build.build_info["fused_bn"]["log"]
    rep = ptxas_report(log, "reduce_kernel") + ptxas_report(log,
                                                            "apply_kernel")
    if len(rep) != 8:
        fail(f"ptxas reported {len(rep)} fused_bn instances, want 8")
    for r in rep:
        m = re.search(r"(reduce|apply)_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                      r["function"])
        r.update(kernel="K1a" if m.group(1) == "reduce" else "K1b",
                 dtype="f32" if m.group(2) == "f" else "bf16",
                 vec=int(m.group(3)))
        r["blocks_per_sm"] = lib.fused_bn_occupancy(
            int(r["kernel"] == "K1b"), int(r["dtype"] == "bf16"), r["vec"])
        print(f"  {r['kernel']} {r['dtype']:4s} vec {r['vec']}: "
              f"{r.get('registers')} registers, {r.get('spill_stores')} / "
              f"{r.get('spill_loads')} bytes spilled (stores / loads), "
              f"{r.get('stack_bytes')} bytes stack, {r['static_smem_bytes']} "
              f"bytes shared memory, {r['blocks_per_sm']} blocks of 256 "
              f"threads an SM")
        if r["vec"] > 1 and (r.get("spill_stores") or r.get("spill_loads")
                             or "spill_stores" not in r):
            fail(f"{r['function']} spills or was not reported: {r}")
    print(f"  (fused_bn instances built on {facts['smi']})")
    return rep


def decode_build_report(build, facts) -> list[dict]:
    """Every decode_kernel instance as ptxas built it: (q, cache) types,
    head dim, query heads a block, dense or paged; registers, spills,
    stack, and static + dynamic shared memory (dynamic from the
    library)."""
    lib = build.load_library("decode_attention")
    rep = ptxas_report(build.build_info["decode_attention"]["log"],
                       "decode_kernel")
    if len(rep) != 32:
        fail(f"ptxas reported {len(rep)} decode_kernel instances, want 32")
    for r in rep:
        m = re.search(r"decode_kernelI(.+?)Li(\d+)ELi(\d+)ELb([01])E",
                      r["function"])
        tp = m.group(1)
        ctype = 0 if tp == "ff" else 2 if tp.endswith("a") else 1
        qname = "f32" if tp.startswith("f") else "bf16"
        r.update(types=f"{qname}/{('f32', 'bf16', 'int8')[ctype]}",
                 d=int(m.group(2)), heads=int(m.group(3)),
                 paged=m.group(4) == "1")
        r["dynamic_smem_bytes"] = lib.decode_attention_smem(
            ctype, r["d"], r["heads"])
        print(f"  decode_kernel {r['types']:9s} D={r['d']:3d} "
              f"G={r['heads']} {'paged' if r['paged'] else 'dense'}: "
              f"{r.get('registers')} registers, {r.get('spill_stores')} / "
              f"{r.get('spill_loads')} bytes spilled (stores / loads), "
              f"{r.get('stack_bytes')} bytes stack, "
              f"{r['static_smem_bytes']} + {r['dynamic_smem_bytes']} bytes "
              f"shared memory (static + dynamic)")
    print(f"  (decode instances built on {facts['smi']})")
    return rep


def print_flash_ratios(timing: dict, facts) -> None:
    """One line each: K2 against SDPA's forward, and K3 + K4 and the
    port's whole backward against SDPA's backward (alternated windows)."""
    if "K2" in timing:
        k2 = timing["K2"]
        print(f"  K2 vs SDPA forward, alternated windows: K2 "
              f"{k2['ms']:.4f} ms, SDPA {k2['library_ms']:.4f} ms, ratio "
              f"{k2['over_library_mean']:.3f}; K2 {k2['tflops_per_s']:.1f} "
              f"TFLOP/s, {k2['bound_share']:.3f} of its "
              f"{k2['bound_ms']:.5f} ms bound ({k2['bound_by']}); "
              f"{facts['smi']}")
    for n, what in (("K3+K4", "K3 + K4"),
                    ("full", "the port's backward (delta + K3 + K4)")):
        t = timing[n]
        print(f"  {what} vs SDPA backward, alternated windows: "
              f"{t['ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, ratio "
              f"{t['over_library']:.3f}; {t['tflops_per_s']:.1f} TFLOP/s, "
              f"{t['bound_share']:.3f} of its {t['bound_ms']:.5f} ms bound "
              f"(K3 {timing['K3']['ms']:.4f} ms, "
              f"{timing['K3']['bound_share']:.3f} of its bound; K4 "
              f"{timing['K4']['ms']:.4f} ms, "
              f"{timing['K4']['bound_share']:.3f}); {facts['smi']}")


def decode_extras(t: dict, build: list[dict], paged: bool) -> dict:
    """A decode kernel's record beyond the contract's keys: its ratio to
    SDPA in alternated windows, its share of the bound, the split plan at
    the timed shape, and the bf16 g = 1 D = 128 instance's build."""
    inst = [r for r in build if r["paged"] == paged and r["d"] == 128
            and r["heads"] == 1 and r["types"].startswith("bf16")]
    return {"over_library": t["over_library"],
            "bound_share": t["bound_share"], "split_len": t["split_len"],
            "n_splits": t["n_splits"],
            "build": [{k: r.get(k) for k in (
                "types", "registers", "spill_stores", "spill_loads",
                "static_smem_bytes", "dynamic_smem_bytes")} for r in inst]}


def print_decode_ratio(name: str, t: dict, facts) -> None:
    """One line: a decode kernel against SDPA in alternated windows, and
    its share of its bound."""
    print(f"  {name} vs SDPA, alternated windows: {name} {t['ms']:.4f} ms, "
          f"SDPA {t['library_ms']:.4f} ms, ratio {t['over_library']:.3f}; "
          f"{t['bound_share']:.3f} of its {t['bound_ms']:.5f} ms bound "
          f"({t['bound_by']}); L = {t['split_len']}, {t['n_splits']} "
          f"splits; {facts['smi']}")


# -- phase 19: data-parallel VGG-11 at world size 1 ------------------------

DP_EXACT = ("all_reduce", "gather_scatter", "gather_scatter_symmetric",
            "ddp", "bucketed", "hierarchical")
DP_APPROX = ("quantized", "quantized_ring", "quantized_ring_ef")
DP_STEPS = 20      # the exact strategies' run, against two plain runs
DP_FUSED_STEPS = 10
DP_WINDOW = 40     # ddp against none, A B B A
DP_LEAVES = 34     # VGG-11's gradient tensors (main_all_reduce.py: 34 ops)


def dp_calls(prof, backend: str = "nccl") -> dict:
    """What a profiled window issued to the backend: the collectives by
    name (the ``nccl:*`` ranges ProcessGroupNCCL records on the host, one
    a call), and the device kernels whose name says nccl, with their
    time."""
    from torch.autograd import DeviceType
    calls, kernels, kernel_us = {}, 0, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CPU and \
                e.name.startswith(backend + ":"):
            calls[e.name] = calls.get(e.name, 0) + 1
        elif e.device_type == DeviceType.CUDA and "nccl" in e.name.lower() \
                and not e.name.startswith("nccl:"):
            kernels += 1
            kernel_us += e.device_time_total
    return {"calls": calls, "nccl_kernels": kernels,
            "nccl_kernel_ms": kernel_us / 1e3}


def dp_phase(torch, port, facts, name: str = "VGG11",
             batch: int = VGG_BATCH) -> dict:
    """Phase 19: the port's data-parallel VGG training at world size 1, over
    a real one-rank NCCL group (parallel.mesh.make_mesh), bf16, no
    augmentation, every strategy on the same seeded params and batches:

    (a) every strategy applied to one saved set of gradients: the exact
        ones (and hierarchical over a 1 x 1 mesh) return them bit for bit,
        a sum over one rank divided by one being the identity, so any
        difference is a read before NCCL's stream was done or a packing
        fault; the rings too (a ring of one rank has no hop and returns
        its input, as the JAX ring does at n = 1); quantized within half
        a quantum of each tensor (its max |g| / 127);
    (b) DP_STEPS steps of each: the exact strategies' params within
        PARAM_TOL of the spread of two plain runs (and a nudged one), as
        phase 13 holds its fused run (cuDNN's backward is not repeatable);
        the approximate ones with a finite, falling loss;
    (d) one profiled step of each: the collectives it issued, gated for
        all_reduce (one all-reduce a leaf), bucketed (one a bucket),
        quantized (two a leaf: max, then sum) and ddp (one, coalesced),
        and the NCCL kernels on the device;
    (e) ddp against none through Trainer in A B B A windows of DP_WINDOW
        steps (ms a step), and a profiled 5-step window each (device ms a
        step, idle share, NCCL's device time): recorded, not gated;
    (f) ddp with fused_bn=True for DP_FUSED_STEPS steps: K1a and K1b
        launched once a BN layer a step, and its params within the spread
        of two plain runs with fused_bn=True."""
    from torch.profiler import ProfilerActivity, profile
    tr, vgg, fb, cifar = (port["train"], port["vgg"], port["fused_bn"],
                          port["cifar10"])
    st, mesh_mod = port["strategies"], port["mesh"]
    n_bn = len(vgg_bn_layers(vgg, name, batch))
    mesh = mesh_mod.make_mesh(device=DEVICE)
    hier_mesh = mesh_mod.make_mesh(axis_names=("dcn", "ici"),
                                   axis_shape=(1, 1), device=DEVICE)
    ds = cifar._synthetic(batch * DP_STEPS, seed=11)
    images = torch.as_tensor(ds.images).to(DEVICE).view(
        DP_STEPS, batch, 32, 32, 3)
    labels = torch.as_tensor(ds.labels).to(DEVICE).long().view(
        DP_STEPS, batch)
    p0, s0 = vgg.init(0, name, device=DEVICE)
    start = {k: t.detach() for k, t in vgg.flatten(p0).items()}

    def cfg(strategy):
        return tr.TrainConfig(model=name, strategy=strategy,
                              batch_size=batch, compute_dtype="bfloat16",
                              augment=False, dcn_size=1)

    def mesh_of(strategy):
        return None if strategy == "none" else \
            hier_mesh if strategy == "hierarchical" else mesh

    def fresh(nudge=0.0):
        params = {k: {n: t.clone().requires_grad_(True) for n, t in
                      v.items()} for k, v in p0.items()}
        if nudge:
            g = torch.Generator(device=DEVICE).manual_seed(9)
            with torch.no_grad():
                for p in vgg.flatten(params).values():
                    p.mul_(1 + nudge * torch.randn(p.shape, generator=g,
                                                   device=DEVICE))
        return params, {k: {n: t.clone() for n, t in v.items()}
                        for k, v in s0.items()}

    def sync_state(strategy, params):
        s = st.get(strategy)
        if not getattr(s, "stateful", False):
            return None
        return s.init_state([params[k][n] for k, n in tr.jax_order(params)],
                            1, device=DEVICE)

    out = {"world_size": 1, "backend": "nccl", "batch": batch,
           "dtype": "bfloat16"}

    # (a) one saved set of gradients through every strategy
    params, state = fresh()
    loss, _ = tr._loss_fn(params, state, None, images[0], labels[0],
                          cfg=cfg("none"))
    loss.backward()
    grads = [params[k][n].grad.detach().clone()
             for k, n in tr.jax_order(params)]
    fixed = {}
    for s_name in DP_EXACT + DP_APPROX:
        strategy = st.get(s_name)
        tr._apply_dcn(cfg(s_name), strategy)
        copies = [g.clone() for g in grads]
        tr.sync_grads(strategy, mesh_of(s_name), copies,
                      sync_state(s_name, params))
        sync(torch)
        if s_name == "quantized":
            over = max(((c - g).abs().max() / (g.abs().max() / 127)).item()
                       for c, g in zip(copies, grads))
            # half a quantum, plus float32's rounding of g / s and of
            # q * s: each at most 127 ulps (|q| <= 127) of the quantum
            fixed[s_name] = {"worst_err_in_quanta": over}
            if not over <= 0.5 + 2 * 127 * 2.0 ** -24:
                fail(f"(a) quantized moved a gradient {over} quanta")
        else:
            equal = all(torch.equal(c, g) for c, g in zip(copies, grads))
            fixed[s_name] = {"bitwise": equal}
            if not equal:
                fail(f"(a) {s_name} at world size 1 changed the gradients")
    out["fixed_gradients"] = fixed
    print("  (a) one set of VGG-11 gradients through each strategy: "
          + json.dumps(fixed))
    del grads, params

    # (b) DP_STEPS steps of each strategy against the plain runs' spread
    def run(strategy, steps=DP_STEPS, fused=None, nudge=0.0):
        params, state = fresh(nudge)
        step = tr.make_train_step(cfg(strategy), mesh=mesh_of(strategy),
                                  fused_bn=fused)
        opt = tr.make_optimizer(cfg(strategy), params)
        carry, losses = sync_state(strategy, params), []
        for i in range(steps):
            loss, state, _, _, carry = step(params, state, opt, i,
                                            images[i % DP_STEPS],
                                            labels[i % DP_STEPS], carry)
            losses.append(loss)
        sync(torch)
        return ({k: p.detach() for k, p in vgg.flatten(params).items()},
                [x.item() for x in losses])

    def gap(a, b):
        num = sum(((a[k] - b[k]).double() ** 2).sum() for k in b)
        den = sum(((b[k] - start[k]).double() ** 2).sum() for k in b)
        return (num / den).sqrt().item()

    (pa, la), (pb, _), (pn, _) = run("none"), run("none"), \
        run("none", nudge=NUDGE)
    spread = max(gap(pb, pa), gap(pn, pa))
    steps_res = {"plain_vs_plain": gap(pb, pa),
                 "nudged_plain": gap(pn, pa),
                 "param_tol": f"{PARAM_TOL} x max(plain vs plain, nudged "
                              f"plain)", "losses_plain": la}
    for s_name in DP_EXACT + DP_APPROX:
        ps, ls = run(s_name)
        steps_res[s_name] = {"gap": gap(ps, pa), "loss_first": ls[0],
                             "loss_last": ls[-1]}
        if not all(np.isfinite(ls)):
            fail(f"(b) {s_name}: losses not finite {ls}")
        if s_name in DP_EXACT and not gap(ps, pa) <= PARAM_TOL * spread:
            fail(f"(b) {s_name}: params after {DP_STEPS} steps "
                 f"{gap(ps, pa)} from the plain run's, beyond "
                 f"{PARAM_TOL} x {spread}")
        if s_name in DP_APPROX and not np.mean(ls[-5:]) < np.mean(ls[:5]):
            fail(f"(b) {s_name}: the loss did not fall: {ls}")
    out["steps"] = steps_res
    print(f"  (b) {DP_STEPS} bf16 steps each, params' gap to a plain run "
          f"(over the distance it moved): " + json.dumps(steps_res))

    # (d) the collectives one step issues
    calls = {}
    for s_name in DP_EXACT + DP_APPROX:
        params, state = fresh()
        step = tr.make_train_step(cfg(s_name), mesh=mesh_of(s_name))
        opt = tr.make_optimizer(cfg(s_name), params)
        carry = sync_state(s_name, params)
        _, state, _, _, carry = step(params, state, opt, 0, images[0],
                                     labels[0], carry)
        sync(torch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(params, state, opt, 1, images[1], labels[1], carry)
            sync(torch)
        calls[s_name] = dp_calls(prof, torch.distributed.get_backend())
    buckets = len(st.make_bucket_plan(
        [p0[k][n] for k, n in tr.jax_order(p0)], st.BUCKET_CAP_MB << 20))
    want = {"all_reduce": DP_LEAVES, "bucketed": buckets,
            "quantized": 2 * DP_LEAVES, "ddp": 1}
    for s_name, n_want in want.items():
        got = calls[s_name]["calls"].get(
            torch.distributed.get_backend() + ":all_reduce", 0)
        if got != n_want:
            fail(f"(d) {s_name}: {got} all-reduces a step, want {n_want}: "
                 f"{calls[s_name]}")
    out["collectives_per_step"] = calls
    print("  (d) NCCL collectives and kernels of one step, by strategy "
          "(world size 1): " + json.dumps(calls))

    # (e) ddp against none through the Trainer, alternated windows
    trainers = {}
    for s_name in ("ddp", "none"):
        t = tr.Trainer(cfg(s_name), device=DEVICE)
        trainers[s_name] = {"t": t, "i": 0, "ms": []}
    order = ["ddp", "none", "none", "ddp"]

    def advance(r, k):
        for _ in range(k):
            j = r["i"] % DP_STEPS
            r["t"].train_steps(images[j][None], labels[j][None])
            r["i"] += 1

    for r in trainers.values():
        advance(r, 3)
    for s_name in order:
        r = trainers[s_name]
        sync(torch)
        t0 = time.perf_counter()
        advance(r, DP_WINDOW)
        sync(torch)
        r["ms"].append((time.perf_counter() - t0) / DP_WINDOW * 1e3)
    windows = {}
    for s_name, r in trainers.items():
        prof = profile(activities=[ProfilerActivity.CUDA])
        sync(torch)
        with prof:
            advance(r, 5)
            sync(torch)
        device_us = sum(e.self_device_time_total for e in
                        prof.key_averages()
                        if e.device_type.name == "CUDA")
        nccl_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type.name == "CUDA"
                      and "nccl" in e.key.lower())
        med = float(np.median(r["ms"]))
        windows[s_name] = {
            "ms_per_step_windows": r["ms"], "ms_per_step_median": med,
            "device_ms_per_step": device_us / 1e3 / 5,
            "nccl_device_ms_per_step": nccl_us / 1e3 / 5,
            "nccl_share_of_device": nccl_us / max(device_us, 1e-9),
            "device_idle_share": 1.0 - device_us / 1e3 / 5 / med}
    windows["ddp_over_none_ms"] = (windows["ddp"]["ms_per_step_median"]
                                   / windows["none"]["ms_per_step_median"])
    windows["ddp_minus_none_device_ms"] = (
        windows["ddp"]["device_ms_per_step"]
        - windows["none"]["device_ms_per_step"])
    out["ddp_vs_none"] = windows
    print(f"  (e) ddp vs none, bf16 batch {batch}, A B B A windows of "
          f"{DP_WINDOW} steps: " + json.dumps(windows) + f"; {facts['smi']}")
    del trainers

    # (f) K1 on the data-parallel path
    fb.bn_relu_bwd_reduce.launches = fb.bn_relu_bwd_apply.launches = 0
    pf, lf = run("ddp", steps=DP_FUSED_STEPS, fused=True)
    k1 = {"K1a": fb.bn_relu_bwd_reduce.launches,
          "K1b": fb.bn_relu_bwd_apply.launches}
    (qa, _), (qb, _), (qn, _) = (
        run("none", steps=DP_FUSED_STEPS, fused=True),
        run("none", steps=DP_FUSED_STEPS, fused=True),
        run("none", steps=DP_FUSED_STEPS, fused=True, nudge=NUDGE))
    fspread = max(gap(qb, qa), gap(qn, qa))
    fused = {"launches": k1, "gap": gap(pf, qa), "plain_vs_plain": gap(qb, qa),
             "nudged_plain": gap(qn, qa), "losses": lf}
    out["fused_ddp"] = fused
    print(f"  (f) ddp with fused_bn=True, {DP_FUSED_STEPS} bf16 steps: "
          + json.dumps(fused))
    want_k1 = n_bn * DP_FUSED_STEPS
    if k1 != {"K1a": want_k1, "K1b": want_k1}:
        fail(f"(f) K1a/K1b launches {k1} under ddp, want {want_k1} each")
    if not fused["gap"] <= PARAM_TOL * fspread:
        fail(f"(f) fused ddp params {fused['gap']} beyond {PARAM_TOL} x "
             f"{fspread}")
    port["parallel_init"].shutdown()
    torch.cuda.empty_cache()
    return out


# -- phase 20: MoE (slice 6b) and LM data parallel (slice 5b) --------------

MOE_EXPERTS = 8
MOE_LAYER = dict(d=1024, f=4096, t=8192)  # LM-base width, 8 x 1024 tokens
MOE_FLAGS = ("--n-experts", str(MOE_EXPERTS))  # lm_cli's flag, JAX's too
MOE_CASES = {"top1": {}, "top2": {"top_k": 2},
             "experts": {"router_mode": "experts"},
             "drops": {"capacity_factor": 0.5}}
# f32 index dispatch against the one-hot form: both round each output once
# from a float64 sum, so they agree bit for bit unless a float64 sum in
# another order lands on a float32 rounding edge; held to 2^-22 of max|out|
MOE_REL_TOL = 2.0 ** -22
MOE_STEPS = 20
LMDP_STEPS = 5
LMDP_MODEL = ("--preset", "LM-base", *MOE_FLAGS)  # (d)'s lm_cli model

# The world-size-1 gang's one rank (launched by launch.py): lm_cli.run with
# the given argv, its losses as float hex, and the collectives step 3
# issued (the host-side <backend>:* ranges of a CPU-activity profile).
LMDP_CHILD = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
torch.backends.cuda.matmul.allow_tf32 = False
from distributed_pytorch_tpu_torch import lm_cli
from distributed_pytorch_tpu_torch.parallel import init as pinit
losses, info = [], {}
prof = profile(activities=[ProfilerActivity.CPU])
def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
def on_step(step, trainer, loss):
    losses.append(loss.detach().clone())
    if step == 2:
        sync()
        prof.start()
    elif step == 3:
        sync()
        prof.stop()
        info["rank_world"] = pinit.process_info()
        info["backend"] = torch.distributed.get_backend()
lm_cli.run(json.loads(sys.argv[1]), on_step=on_step)
calls = {}
for e in prof.events():
    if e.name.startswith(info["backend"] + ":"):
        calls[e.name] = calls.get(e.name, 0) + 1
print("LMDP " + json.dumps({"losses": [float(x).hex() for x in losses],
                            "calls": calls,
                            "group_left": torch.distributed.is_initialized(),
                            **info}), flush=True)
"""


def moe_port(port) -> dict:
    """``port`` with LM-base at ``--n-experts 8``: 12 of the 24 layers MoE
    (moe_every 2), top-1, capacity factor 2 (the TransformerConfig
    defaults)."""
    import dataclasses
    return dict(port, cfg=dataclasses.replace(port["cfg"],
                                              n_experts=MOE_EXPERTS))


def moe_layer_checks(torch, port) -> dict:
    """Phase 20 (a), the layer: ``ops.moe.moe_apply`` at LM-base width
    (T = 8192 tokens, D 1024, F 4096, E 8) in float32 on the card against
    ``moe_apply_plain``, the one-hot einsum form, on the same inputs, for
    top-1, top-2, expert choice and capacity factor 0.5 (drops): out
    within MOE_REL_TOL of max|out| (bitwise reported), aux equal, and the
    drop share.  Then bf16 (f32 params, as the step holds them): the
    forward by index against the one-hot form, and one layer's forward +
    backward as the step runs it (device ms, CUDA events)."""
    moe = port["moe"]
    d, f, t, e = MOE_LAYER["d"], MOE_LAYER["f"], MOE_LAYER["t"], MOE_EXPERTS
    g = torch.Generator(device=DEVICE).manual_seed(20)
    params = moe.moe_init(g, d, f, e, torch.device(DEVICE))
    x = torch.randn((t, d), generator=g, device=DEVICE)
    out = {"cases": {}}
    for name, kw in MOE_CASES.items():
        stats = {}
        with torch.no_grad():
            got, aux = moe.moe_apply(params, x, n_experts=e, stats=stats,
                                     **kw)
            want, want_aux = moe.moe_apply_plain(params, x, n_experts=e,
                                                 **kw)
        err = (got - want).abs().max().item()
        tol = MOE_REL_TOL * want.abs().max().item()
        res = {"max_abs_err": err, "tol": tol,
               "bitwise": bool(torch.equal(got, want)), "aux": float(aux),
               "aux_equal": float(aux) == float(want_aux),
               "capacity": moe.capacity(t, e, kw.get("top_k", 1),
                                        kw.get("capacity_factor", 2.0)),
               "drop_share": 1.0 - float(stats["kept"])
               / float(stats["routed"])}
        out["cases"][name] = res
        if not (err <= tol and res["aux_equal"]
                and bool(torch.isfinite(got).all())):
            fail(f"(a) moe_apply {name} differs from its one-hot form: "
                 f"{res}")
        del got, want
        torch.cuda.empty_cache()
    print(f"  (a) moe_apply (f32, T={t} D={d} F={f} E={e}) against the "
          "one-hot form on the card: " + json.dumps(out["cases"]))
    xb = x.bfloat16()

    def fwd(fn):
        def run():
            with torch.no_grad():
                fn(params, xb, n_experts=e)
        return run

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xg = xb.clone().requires_grad_(True)

    def fwd_bwd():
        o, a = moe.moe_apply(leaves, xg, n_experts=e)
        torch.autograd.grad(o.float().sum() + a, [xg, *leaves.values()])

    out["bf16_fwd_ms"] = time_ms(torch, fwd(moe.moe_apply), iters=10)
    out["bf16_fwd_one_hot_ms"] = time_ms(torch, fwd(moe.moe_apply_plain),
                                         iters=10)
    out["bf16_fwd_bwd_ms"] = time_ms(torch, fwd_bwd, iters=10)
    print("  (a) one MoE layer in bf16, top-1, device ms: forward "
          f"{out['bf16_fwd_ms']:.4f} (one-hot form "
          f"{out['bf16_fwd_one_hot_ms']:.4f}), forward + backward "
          f"{out['bf16_fwd_bwd_ms']:.4f}")
    del params, leaves, x, xb, xg
    torch.cuda.empty_cache()
    return out


def moe_batch_stats(torch, port, trainer) -> dict:
    """The trained MoE model on lm_cli's first batch (seed 1, epoch 0):
    the summed aux of one bf16 forward and the share of (token, choice)
    pairs its MoE layers dropped, read through ``moe_apply``'s stats."""
    moe, tfm, corpus = port["moe"], port["tfm"], port["corpus"]
    loader = corpus.LMDataLoader(corpus.load_corpus(None), 8, 1024, seed=1,
                                 shuffle_mode="permutation")
    loader.set_epoch(0)
    tokens, _ = next(iter(loader))
    kept, routed = [], []
    real = moe.moe_apply

    def counting(*a, **kw):
        st = {}
        r = real(*a, stats=st, **kw)
        kept.append(st["kept"])
        routed.append(st["routed"])
        return r

    moe.moe_apply = counting
    try:
        with torch.no_grad():
            params = {n: p.detach() for n, p in trainer.params.items()}
            _, aux = tfm.apply(params, torch.as_tensor(tokens).to(DEVICE)
                               .long(), cfg=trainer.cfg.model,
                               dtype=torch.bfloat16, return_aux=True)
    finally:
        moe.moe_apply = real
    return {"aux_after_training": float(aux), "moe_layers": len(kept),
            "drop_share_after_training":
                1.0 - float(sum(kept)) / float(sum(routed))}


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def run_gang_of_one(argv: list[str], timeout_s: float = 400.0):
    """``launch.py --nproc-per-node 1`` running LMDP_CHILD over ``argv`` in
    a session of its own (killed whole on a timeout); its exit code and
    output."""
    import os
    import signal
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_pytorch_tpu_torch.launch",
         "--nproc-per-node", "1", "--master-port", str(free_port()), "--",
         "-c", LMDP_CHILD, json.dumps(argv)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        text, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"(d) the gang of one did not finish in {timeout_s} s")
    return proc.returncode, text


def moe_phase(torch, port, facts) -> dict:
    """Phase 20: LM-base with ``--n-experts 8`` (12 MoE layers of 8 SwiGLU
    experts, ~1.46 B parameters, ~403 M active a token), random weights
    from a seed.

    (a) f32: ``moe_layer_checks``; one 2-layer LM-base-width train step
        (layer 1 MoE) through flash against reference attention at phase
        7's bounds; the MoE batcher's greedy tokens against static
        generate() on phase 4's prompts, near-ties allowed as there;
    (b) bf16: MOE_STEPS steps of ``lm_cli --preset LM-base --n-experts 8``
        at 8 x 1024 through ``training_run`` (ms/step, tokens/s, peak
        memory, idle share, device operations a step, mfu over the active
        parameters, a falling loss; gated: K2, K3, K4 once per layer per
        step), the MoE layers' share of the step's device time (12 x one
        layer's forward + backward from (a), over the profiled step), and
        the trained model's aux and drop share;
    (c) bf16 serving: phase 5's second load (8 requests of 32-64 new
        tokens; its 16-request load until slice 5c-ii's phase 24 took the
        time) through the batcher at its defaults, dense and paged
        (tokens/s, TTFT; gated: K6, resp. K8, once per layer per decode
        step);
    (d) LM data parallel at world size 1: LMDP_STEPS bf16 steps of the same
        lm_cli run through ``launch.py --nproc-per-node 1`` with
        ``--rendezvous env --dp 1`` (a one-rank NCCL group), gated bitwise
        against the same run with no process group, and the collectives
        a step issues (gated: two all-reduces, the count and the flat
        sum)."""
    import dataclasses
    mport = moe_port(port)
    out = {"a": moe_layer_checks(torch, port)}
    out["a"]["train_step"] = train_step_check(
        torch, port, label="f32 MoE step (layer 1, 8 experts)",
        n_experts=MOE_EXPERTS)
    exact_cfg = mport["cfg"]
    params = mport["tfm"].init(0, exact_cfg, device=DEVICE,
                               dtype=torch.float32)
    rng = np.random.default_rng(1)
    lens, max_new = (7, 45, 130, 300), 24   # phase 4's load
    prompts = [rng.integers(0, exact_cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    cb = mport["serve"].ContinuousBatcher(
        params, exact_cfg, slots=2, max_len=512, temperature=0.0,
        prompt_buckets=(64, 512), device=DEVICE)
    got = cb.run(prompts, max_new=max_new)
    flips = check_greedy(torch, mport, params, prompts, got, max_new,
                         "MoE f32 batcher")
    out["a"]["batcher_near_tie_flips"] = flips
    print(f"  (a) MoE f32 batcher vs static generate: {len(prompts)} "
          f"requests, {flips} near-tie flips")
    del params, cb
    torch.cuda.empty_cache()

    train = training_run(
        torch, mport, steps=MOE_STEPS, extra=MOE_FLAGS,
        label="(b) LM-base MoE bf16 training",
        inspect=lambda tr: moe_batch_stats(torch, port, tr))
    n_moe = sum(exact_cfg.is_moe_layer(i) for i in range(exact_cfg.n_layers))
    train["moe_share_of_device_time"] = (
        n_moe * out["a"]["bf16_fwd_bwd_ms"]
        / max(train["device_ms_per_step"], 1e-9))
    out["b"] = train
    print(f"  (b) MoE layers' share of the step's device time: "
          f"{train['moe_share_of_device_time']:.3f} ({n_moe} x "
          f"{out['a']['bf16_fwd_bwd_ms']:.3f} ms of "
          f"{train['device_ms_per_step']:.2f}); {facts['smi']}")

    load = phase5_load(exact_cfg, 8, (32, 64))
    out["c"] = {}
    for name, kw in (("dense", {}), ("paged", {"paged": True})):
        r = serving_run(torch, mport, label=f"(c) MoE bf16 {name}",
                        prompts=load[0], max_new=load[1], window_blocks=0,
                        **kw)
        out["c"][name] = r
    out["c"]["paged_tokens_equal_dense"] = all(
        np.array_equal(a, b) for a, b in zip(out["c"]["dense"]["tokens"],
                                             out["c"]["paged"]["tokens"]))
    for r in ("dense", "paged"):
        del out["c"][r]["tokens"]

    argv = [*LMDP_MODEL, "--steps", str(LMDP_STEPS),
            "--batch-size", "8", "--seq-len", "1024", "--compute-dtype",
            "bfloat16", "--log-every", str(LMDP_STEPS), "--device", DEVICE]
    solo = []
    t0 = time.perf_counter()
    port["lm_cli"].run(argv, on_step=lambda step, tr, loss: solo.append(
        loss.detach().clone()))
    solo = [float(x) for x in solo]
    solo_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc, text = run_gang_of_one(argv + ["--rendezvous", "env", "--dp", "1"])
    lines = [ln for ln in text.splitlines() if ln.startswith("LMDP ")]
    if rc or not lines:
        fail(f"(d) the gang of one failed ({rc}):\n{text[-3000:]}")
    gang = json.loads(lines[-1][len("LMDP "):])
    gang_losses = [float.fromhex(h) for h in gang["losses"]]
    d = {"losses_no_group": solo, "losses_gang_of_one": gang_losses,
         "bitwise": gang_losses == solo, "rank_world": gang["rank_world"],
         "backend": gang["backend"], "collectives_step_3": gang["calls"],
         "group_left_after_run": gang["group_left"],
         "wall_s_no_group": solo_s,
         "wall_s_gang": time.perf_counter() - t0}
    out["d"] = d
    print("  (d) lm_cli --rendezvous env --dp 1 under launch.py against "
          "the run with no process group: " + json.dumps(d))
    if not d["bitwise"] or len(solo) != LMDP_STEPS:
        fail(f"(d) the gang of one's losses differ from the run without a "
             f"group: {gang_losses} vs {solo}")
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    if d["rank_world"] != [0, 1] or d["backend"] != backend \
            or d["group_left_after_run"]:
        fail(f"(d) not a one-rank {backend} group destroyed after the run: "
             f"{d}")
    if gang["calls"].get(f"{backend}:all_reduce") != 2:
        fail(f"(d) a step issued {gang['calls']}, want two all-reduces")
    return out


# -- phase 21: the per-step sync knobs at world size 1 (slice 5b-ii) --------

OV_STRATEGIES = {"ddp": {}, "bucketed": {}, "quantized": {},
                 "quantized_ring": {}, "quantized_ring_ef": {},
                 "hierarchical": {},
                 "hierarchical_int8": {"dcn_compress": "int8"},
                 "hierarchical_int4": {"dcn_compress": "int4"}}
OV_STEPS = 10      # (a): each strategy, overlapped and post-backward
OV_BUCKET_MB = 10  # (b): VGG-11's 36.9 MB of gradients in >= 3 buckets
OV_WINDOW = 20     # (b): overlap against post-backward, A B B A, twice


def _ov_step(port, name: str, overlap: bool, mesh, hier_mesh,
             bucket_mb=None):
    """The bf16 VGG-11 train step of ``name`` (a strategy, or hierarchical
    with its compressed hop) over the one-rank group: (step, strategy)."""
    tr, st = port["train"], port["strategies"]
    strategy = name.split("_int")[0]
    cfg = tr.TrainConfig(model="VGG11", strategy=strategy,
                         batch_size=VGG_BATCH, compute_dtype="bfloat16",
                         augment=False, dcn_size=1, overlap=overlap,
                         overlap_bucket_mb=bucket_mb, **OV_STRATEGIES[name])
    s = st.get(strategy)
    return tr.make_train_step(cfg, s, hier_mesh if strategy ==
                              "hierarchical" else mesh), s, cfg


def _fresh(p0, s0):
    return ({k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
             for k, v in p0.items()},
            {k: {n: t.clone() for n, t in v.items()} for k, v in s0.items()})


def _ov_run(torch, port, name: str, overlap: bool, images, labels, p0, s0,
            mesh, hier_mesh):
    """OV_STEPS steps of ``_ov_step``'s step from phase 19's params and
    batches: (losses, params, BN state, residual)."""
    tr, vgg = port["train"], port["vgg"]
    step, s, cfg = _ov_step(port, name, overlap, mesh, hier_mesh)
    params, state = _fresh(p0, s0)
    opt = tr.make_optimizer(cfg, params)
    carry = None
    if getattr(s, "stateful", False):
        carry = s.init_state([params[k][n] for k, n in tr.jax_order(params)],
                             1, device=DEVICE)
    losses = []
    for i in range(OV_STEPS):
        loss, state, _, _, carry = step(params, state, opt, i,
                                        images[i % DP_STEPS],
                                        labels[i % DP_STEPS], carry)
        losses.append(loss)
    sync(torch)
    return (torch.stack(losses), vgg.flatten(params), vgg.flatten(state),
            carry)


def _placement(prof, backend: str) -> dict:
    """Where one profiled step's gradient all-reduces started: the host-side
    ``<backend>:all_reduce`` calls' start times, against the start of the last
    compute node the autograd engine evaluated (the step's last backward
    kernel launches from it; the sync points' own nodes excluded)."""
    calls, nodes = [], []
    for e in prof.events():
        if e.name == backend + ":all_reduce":
            calls.append(e.time_range.start)
        elif e.name.startswith("autograd::engine::evaluate_function:") \
                and "SyncPoint" not in e.name \
                and "AccumulateGrad" not in e.name:
            nodes.append(e.time_range.start)
    last = max(nodes) if nodes else None
    return {"calls": len(calls), "backward_nodes": len(nodes),
            "calls_before_last_backward_node":
                sum(1 for c in calls if last is not None and c < last)}


def _lm_codec_leaves(torch, port):
    """LM-base's parameters (lm_cli's byte vocabulary, as phase 8 trains
    it; every leaf, seeded) on the card, each with its ZeRO-3 dim over a
    slice-local data axis of 8."""
    lm = port["lm"]
    cfg = lm.LMTrainConfig(model=lm_base_bytes(port), dp=8, fsdp=True)
    shapes = lm.param_shapes(cfg.model)
    specs = lm.param_specs(cfg, shapes)
    g = torch.Generator(device=DEVICE).manual_seed(21)
    return [(n, torch.randn(shapes[n], generator=g, device=DEVICE) * 0.02,
             lm.fsdp_dim(specs[n])) for n in lm.jax_order(shapes)]


def _ring_codec(ring, flat, residual):
    """One dcn ring hop's codec on a rank, re-composed here from
    ``QuantizedRing``'s helpers (a ring of one rank is the identity, so at
    world size 1 ``_ring_sum`` itself never runs them): the residual added
    (error feedback), block quantize, the dropped error (the new residual),
    the int4 nibble packing and its unpacking, and the dequantize of what
    arrives.  Its ms stand for ``_ring_sum``'s per-hop work without the
    wire, not for a call of the port's."""
    acc = flat + residual
    q, s = ring._quant(acc)
    err = ring._dequant_add(q, s, acc, -1.0)
    if ring.bits == 4:
        q = ring._unpack(ring._pack(q), q.shape)
    return ring._dequant(q, s), err


def sync_knobs_phase(torch, port, facts) -> dict:
    """Phase 21: the per-step sync knobs (slice 5b-ii) at world size 1,
    over a real one-rank NCCL group (the multi-rank paths need two or more
    cards: NCCL puts no two ranks on one GPU), bf16, phase 19's seeded
    VGG-11 params and batches, cuDNN in its deterministic algorithms (as
    the two runs of a gate must be repeatable):

    (a) VGG-11 ``overlap=True`` for every overlap-capable strategy (and
        hierarchical's compressed hops) for OV_STEPS steps: losses,
        params, BN state and residual bitwise the post-backward run's.
        At world size 1 a ring of one rank is the identity: the
        quantized_ring(_ef) and hierarchical int8 / int4 runs quantize
        nothing and their residual stays zero (``residual_max_abs``), so
        their gates hold the overlap path's buckets, residual segments
        and layout, not the codec, which (c) and the CPU gangs hold;
    (b) one profiled overlapped ddp step at OV_BUCKET_MB-MB buckets: one
        NCCL call a bucket, each but the last-due one issued before the
        backward's last compute node (the post-backward step's after it);
        and overlap against post-backward through ``Trainer`` in A B B A
        windows of OV_WINDOW steps, twice: ms a step, their ratio, the
        device's idle share (no gain claimed: the step is host-bound) and
        the peak device memory of a window;
    (c) the LM sync codecs at LM-base width: the ZeRO-3 gather at int8
        and int4 over every leaf through the one-rank group (the port's
        ``_gather_codec``), bitwise its plain codec without the collective
        and the CPU's codec on the same leaf; the dcn ring's per-hop codec
        (quantize, pack, dequantize and EF update, ``_ring_codec``: a
        re-composition of ``_ring_sum``'s per-hop work from its helpers,
        since a one-rank ring runs none) on LM-base's flat gradient,
        bitwise the CPU's; ms of each for one step's worth (every leaf
        once)."""
    from torch.profiler import ProfilerActivity, profile
    tr, st, vgg, cifar = (port["train"], port["strategies"], port["vgg"],
                          port["cifar10"])
    mesh_mod, lm = port["mesh"], port["lm"]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mesh = mesh_mod.make_mesh(device=DEVICE)
    hier_mesh = mesh_mod.make_mesh(axis_names=("dcn", "ici"),
                                   axis_shape=(1, 1), device=DEVICE)
    backend = torch.distributed.get_backend()
    ds = cifar._synthetic(VGG_BATCH * DP_STEPS, seed=11)
    images = torch.as_tensor(ds.images).to(DEVICE).view(
        DP_STEPS, VGG_BATCH, 32, 32, 3)
    labels = torch.as_tensor(ds.labels).to(DEVICE).long().view(
        DP_STEPS, VGG_BATCH)
    p0, s0 = vgg.init(0, "VGG11", device=DEVICE)
    run = dict(torch=torch, port=port, images=images, labels=labels, p0=p0,
               s0=s0, mesh=mesh, hier_mesh=hier_mesh)
    out = {"world_size": 1, "backend": backend, "dtype": "bfloat16",
           "card": facts["smi"]}
    dtypes = (("int8", 8), ("int4", 4))

    # (c)'s ring inputs, LM-base's flat gradient length, seeded on the
    # card; their CPU oracles (~8 s each, memory-bound) run in a thread
    # beside (a), whose steps keep one host core busy
    shapes = lm.param_shapes(lm_base_bytes(port))
    n_params = sum(math.prod(v) for v in shapes.values())
    ring_len = -(-n_params // 256) * 256
    g = torch.Generator(device=DEVICE).manual_seed(22)
    flat_cpu = (torch.randn(ring_len, generator=g, device=DEVICE)
                * 1e-3).cpu()
    residual_cpu = (torch.randn(ring_len, generator=g, device=DEVICE)
                    * 1e-5).cpu()
    pool = ThreadPoolExecutor(1)
    oracles = {dtype: pool.submit(_ring_codec, st.QuantizedRing(bits=bits),
                                  flat_cpu, residual_cpu)
               for dtype, bits in dtypes}

    # (a) every overlap-capable strategy, overlapped against post-backward
    t0 = time.perf_counter()
    gates = {}
    for name in OV_STRATEGIES:
        a = _ov_run(name=name, overlap=False, **run)
        b = _ov_run(name=name, overlap=True, **run)
        same = {"losses": torch.equal(a[0], b[0]),
                "params": all(torch.equal(a[1][k], b[1][k]) for k in a[1]),
                "bn_state": all(torch.equal(a[2][k], b[2][k]) for k in a[2]),
                "residual": (a[3] is None and b[3] is None)
                or torch.equal(a[3], b[3])}
        gates[name] = {**same, "loss_first": a[0][0].item(),
                       "loss_last": a[0][-1].item(),
                       "residual_len": 0 if a[3] is None else a[3].numel(),
                       "residual_max_abs": None if a[3] is None
                       else a[3].abs().max().item()}
        if not all(same.values()):
            fail(f"(a) {name}: overlap=True is not bitwise the "
                 f"post-backward run: {same}")
    want_ring = {dtype: f.result() for dtype, f in oracles.items()}
    pool.shutdown()
    out["a"] = {"steps": OV_STEPS, "runs": gates,
                "seconds": time.perf_counter() - t0}
    print(f"  (a) VGG-11 overlap=True against post-backward, {OV_STEPS} "
          f"bf16 steps each: " + json.dumps(out["a"]))

    # (b) the collectives move into the backward
    t0 = time.perf_counter()
    leaves = [p0[k][n] for k, n in tr.jax_order(p0)]
    n_buckets = len(st.make_bucket_plan(leaves, OV_BUCKET_MB << 20))
    if n_buckets < 3:
        fail(f"(b) {OV_BUCKET_MB} MB buckets pack VGG-11 into {n_buckets}")
    place = {}
    for overlap in (True, False):
        step, _, cfg = _ov_step(port, "ddp", overlap, mesh, hier_mesh,
                                bucket_mb=OV_BUCKET_MB)
        params, state = _fresh(p0, s0)
        opt = tr.make_optimizer(cfg, params)
        _, state, *_ = step(params, state, opt, 0, images[0], labels[0])
        sync(torch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(params, state, opt, 1, images[1], labels[1])
            sync(torch)
        place["overlap" if overlap else "post_backward"] = _placement(
            prof, backend)
    ov, post = place["overlap"], place["post_backward"]
    if ov["calls"] != n_buckets or post["calls"] != 1:
        fail(f"(b) {ov['calls']} calls overlapped and {post['calls']} "
             f"post-backward for {n_buckets} buckets: {place}")
    if ov["calls_before_last_backward_node"] < n_buckets - 1 \
            or post["calls_before_last_backward_node"] != 0:
        fail(f"(b) the bucket calls were not issued inside the backward: "
             f"{place}")
    trainers = {}
    for overlap in (True, False):
        t = tr.Trainer(tr.TrainConfig(
            model="VGG11", strategy="ddp", batch_size=VGG_BATCH,
            compute_dtype="bfloat16", augment=False, overlap=overlap),
            device=DEVICE)
        trainers["overlap" if overlap else "post_backward"] = {
            "t": t, "i": 0, "ms": []}

    def advance(r, k):
        for _ in range(k):
            j = r["i"] % DP_STEPS
            r["t"].train_steps(images[j][None], labels[j][None])
            r["i"] += 1

    for r in trainers.values():
        advance(r, 3)
    for _ in range(2):
        for key in ("overlap", "post_backward", "post_backward", "overlap"):
            r = trainers[key]
            sync(torch)
            t1 = time.perf_counter()
            advance(r, OV_WINDOW)
            sync(torch)
            r["ms"].append((time.perf_counter() - t1) / OV_WINDOW * 1e3)
    windows = {}
    for key, r in trainers.items():
        prof = profile(activities=[ProfilerActivity.CUDA])
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        with prof:
            advance(r, 5)
            sync(torch)
        wall = (time.perf_counter() - t1) / 5 * 1e3
        peak = torch.cuda.max_memory_allocated()
        device_us = sum(e.self_device_time_total for e in
                        prof.key_averages() if e.device_type.name == "CUDA")
        windows[key] = {"ms_per_step_windows": r["ms"],
                        "ms_per_step_median": float(np.median(r["ms"])),
                        "device_ms_per_step": device_us / 1e3 / 5,
                        "profiled_wall_ms_per_step": wall,
                        "device_idle_share": 1.0 - device_us / 1e3 / 5
                        / wall,
                        "peak_allocated_gb": peak / 1e9}
    windows["overlap_over_post_backward_ms"] = (
        windows["overlap"]["ms_per_step_median"]
        / windows["post_backward"]["ms_per_step_median"])
    del trainers
    out["b"] = {"buckets": n_buckets, "bucket_mb": OV_BUCKET_MB,
                "placement": place, "windows": windows,
                "seconds": time.perf_counter() - t0}
    print(f"  (b) ddp in {n_buckets} buckets of {OV_BUCKET_MB} MB: "
          + json.dumps(out["b"]) + f"; {facts['smi']}")
    port["parallel_init"].shutdown()
    torch.backends.cudnn.deterministic = det

    # (c) the LM sync codecs at LM-base width
    t0 = time.perf_counter()
    mesh = mesh_mod.make_mesh(device=DEVICE)
    group = mesh.get_group()
    leaves = _lm_codec_leaves(torch, port)

    def gather_all(dtype):
        return [lm._gather_codec(x, d, group, dtype) for _, x, d in leaves]

    got = {dtype: gather_all(dtype) for dtype, _ in dtypes}
    bad = []
    for i, (name, x, d) in enumerate(leaves):
        xc = x.cpu()
        for dtype, bits in dtypes:
            q, s = lm.quantize_rows(x, d, bits)
            plain = (q.float() * s).to(x.dtype)
            qc, sc = lm.quantize_rows(xc, d, bits)
            if bits == 4:  # through the nibble packing, as the wire has it
                qc = lm.unpack_rows(lm.pack_rows(qc, d), d, x.shape[d])
            g = got[dtype][i]
            if not (torch.equal(g, plain)
                    and torch.equal(g.cpu(), (qc.float() * sc).to(x.dtype))):
                bad.append((dtype, name))
    del got
    if bad:
        fail(f"(c) the gathers differ from their plain codec or the CPU's "
             f"on {bad[:5]}")
    codecs = {}
    for dtype, _ in dtypes:
        codecs[f"fsdp_gather_{dtype}"] = {
            "leaves": len(leaves), "params": n_params,
            "ms_per_step": time_ms(torch, lambda dtype=dtype: gather_all(
                dtype), iters=5, warmup=1),
            "bitwise_plain_and_cpu": True}
    codecs["fsdp_seconds"] = time.perf_counter() - t0
    del leaves
    flat, residual = flat_cpu.to(DEVICE), residual_cpu.to(DEVICE)
    for dtype, bits in dtypes:
        ring = st.QuantizedRing(bits=bits)
        got, err = _ring_codec(ring, flat, residual)
        want, werr = want_ring.pop(dtype)
        same = torch.equal(got.cpu(), want) and torch.equal(err.cpu(), werr)
        del got, err, want, werr
        if not same:
            fail(f"(c) the {dtype} dcn ring codec differs from the CPU's")
        codecs[f"dcn_ring_{dtype}"] = {
            "elements": ring_len, "bitwise_cpu": True,
            "timed": "_ring_codec: _ring_sum's per-hop work re-composed",
            "ms_per_step": time_ms(
                torch, lambda ring=ring: _ring_codec(ring, flat, residual),
                iters=5, warmup=1)}
    codecs["ring_seconds"] = time.perf_counter() - t0 - codecs[
        "fsdp_seconds"]
    del flat, residual, flat_cpu, residual_cpu
    port["parallel_init"].shutdown()
    torch.cuda.empty_cache()
    out["c"] = {**codecs, "seconds": time.perf_counter() - t0}
    print("  (c) the LM sync codecs at LM-base width (one step's worth): "
          + json.dumps(out["c"]) + f"; {facts['smi']}")
    return out


# -- phase 22: the sync windows (slice 5b-iii) -----------------------------

WIN_H = 4          # the window, in steps
WIN_STEPS = 8      # two windows
WIN_WINDOW = 20    # (b): H=4 against H=1, A B B A, twice
WIN_MOMENTUM = {"ddp": {}, "quantized_ring_ef": {},
                "hierarchical_int8": {"dcn_compress": "int8"}}
WIN_OUTER = {"nesterov": dict(outer_momentum=0.9, outer_lr=1.0),
             "momentum": dict(outer_momentum=0.9, outer_lr=0.7)}
WIN_LM_LEAVES = ("embed", "layers.0.wq", "layers.0.attn_norm")


def _win_trainer(port, p0, s0, **kw):
    """A VGG-11 Trainer over the one-rank group from phase 19's params,
    ``steps_per_loop = WIN_H``."""
    tr = port["train"]
    cfg = tr.TrainConfig(model="VGG11", batch_size=VGG_BATCH, augment=False,
                         steps_per_loop=WIN_H, dcn_size=1, **kw)
    t = tr.Trainer(cfg, device=DEVICE)
    t.load_state(*_fresh(p0, s0))
    return t


def _win_run(torch, t, images, labels, on_boundary=None):
    """WIN_STEPS steps, a window a ``train_steps`` call: the losses."""
    losses = []
    for w in range(0, WIN_STEPS, WIN_H):
        losses.append(t.train_steps(images[w:w + WIN_H],
                                    labels[w:w + WIN_H]))
        if on_boundary is not None:
            on_boundary()
    return torch.cat(losses)


def _plain_outer(kind, mu, lr, a, d, m):
    """The outer step in plain torch: ``m' = mu m + d``, the step ``mu m'
    + d`` (nesterov) or ``m'`` (momentum), ``a + lr step``; each
    multiply-add in float64 rounded once to float32."""
    mu, lr = float(np.float32(mu)), float(np.float32(lr))
    m2 = (m.double() * mu + d.double()).float()
    step = (m2.double() * mu + d.double()).float() if kind == "nesterov" \
        else m2
    return (step.double() * lr + a.double()).float(), m2


def windows_phase(torch, port, facts) -> dict:
    """Phase 22: the sync windows (slice 5b-iii) at world size 1, over a
    real one-rank NCCL group (an LM window needs dcn_size >= 2, so two
    processes and two cards: its multi-rank runs are the CPU gangs'),
    phase 19's seeded VGG-11 params and batches, cuDNN in its
    deterministic algorithms (two runs of a gate must repeat):

    (a) local-SGD windows of WIN_H steps, WIN_STEPS steps: ``ddp`` with
        plain SGD (momentum 0, weight decay 0) in f32 against the
        accumulated-update oracle in plain torch (each window's steps at
        anchor + delta, the anchor moved by the delta: a mean over one
        rank), atol 2e-4 (JAX tests/test_localsgd.py); the trivial outer
        optimizer (momentum 0, lr 1) bitwise that run; nesterov and
        momentum: after each boundary the anchor and the outer momentum
        (the tail of ``sync_state``) bitwise ``_plain_outer`` of the
        anchor before, the exchanged delta (read as the boundary
        returns it) and the momentum before; momentum SGD in bf16 under
        ddp, quantized_ring_ef and hierarchical int8 (1 x 1) against the
        same strategy's per-step run: step 0's loss within rtol 1e-5 (the
        window's first step is the per-step one), the curve within rtol
        1e-1 (JAX's band), the residual finite;
    (b) one profiled WIN_STEPS-step ddp run at H = WIN_H and one per-step:
        the NCCL calls by name (``dp_calls``): the window's gradient
        all-reduces are its exchanges, one a window, none in the local
        steps (a ``train_steps`` call adds one all-reduce of its losses,
        and ddp's broadcast buffers one broadcast a step, in both runs);
        then H = WIN_H against H = 1 in A B B A windows of WIN_WINDOW
        steps, twice: ms a step, ratio, and a profiled window's idle
        share.  No gain is claimed: at world size 1 an exchange is a
        one-rank all-reduce, and the VGG step is host-bound;
    (c) the LM window arithmetic over LM-base's params (lm_cli's byte
        vocabulary), float32, seeded on the card: ``anchor + delta`` (each
        local step's params) and the nesterov ``OuterOptimizer.apply``
        (each boundary), ms beside the bytes each must move at the card's
        memory rate; the outer step bitwise the CPU's on WIN_LM_LEAVES;
        the per-slice mask (kept and skipped) with the prescale
        (``lm.window_prescale``) bitwise the CPU's on the same leaves."""
    from torch.profiler import ProfilerActivity, profile
    tr, vgg, cifar, st, lm = (port["train"], port["vgg"], port["cifar10"],
                              port["strategies"], port["lm"])
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ds = cifar._synthetic(VGG_BATCH * WIN_WINDOW, seed=11)
    images = torch.as_tensor(ds.images).to(DEVICE).view(
        WIN_WINDOW, VGG_BATCH, 32, 32, 3)
    labels = torch.as_tensor(ds.labels).to(DEVICE).long().view(
        WIN_WINDOW, VGG_BATCH)
    p0, s0 = vgg.init(0, "VGG11", device=DEVICE)
    out = {"world_size": 1, "backend": "nccl", "H": WIN_H,
           "card": facts["smi"]}
    plain = dict(strategy="ddp", momentum=0.0, weight_decay=0.0,
                 sync_every=WIN_H, max_sync_every=WIN_H)

    # (a) the plain window against its oracle, the trivial outer optimizer
    t0 = time.perf_counter()
    t = _win_trainer(port, p0, s0, **plain)
    plain_losses = _win_run(torch, t, images, labels)
    got = vgg.flatten(t.params)
    cfg = t.cfg
    anchor, state = _fresh(p0, s0)
    names = tr.jax_order(anchor)
    for w in range(0, WIN_STEPS, WIN_H):
        delta = [torch.zeros_like(anchor[k][n]) for k, n in names]
        for i in range(w, w + WIN_H):
            local = {}
            leaves = []
            for (k, n), dl in zip(names, delta):
                x = (anchor[k][n].detach() + dl).requires_grad_(True)
                local.setdefault(k, {})[n] = x
                leaves.append(x)
            loss, _ = tr._loss_fn(local, state, None, images[i], labels[i],
                                  cfg=cfg)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for dl, g in zip(delta, grads):  # the update -lr g
                    dl.add_(g * -cfg.lr)
        with torch.no_grad():
            for (k, n), dl in zip(names, delta):
                anchor[k][n].add_(dl)
    want = vgg.flatten(anchor)
    oracle_err = max((got[k] - want[k]).abs().max().item() for k in want)
    moved = max((want[k] - vgg.flatten(p0)[k]).abs().max().item()
                for k in want)
    if not oracle_err <= 2e-4:
        fail(f"(a) the plain window is {oracle_err} from the accumulated-"
             f"update oracle")
    t2 = _win_trainer(port, p0, s0, outer_opt="nesterov",
                      outer_momentum=0.0, **plain)
    trivial_losses = _win_run(torch, t2, images, labels)
    trivial_same = torch.equal(plain_losses, trivial_losses) and all(
        torch.equal(v, vgg.flatten(t2.params)[k]) for k, v in got.items()) \
        and t2.sync_state.numel() == 0
    if not trivial_same:
        fail("(a) the trivial outer optimizer is not bitwise the plain "
             "window")
    del t, t2
    res = {"plain": {"steps": WIN_STEPS, "dtype": "float32",
                     "oracle_max_abs_err": oracle_err,
                     "max_param_move": moved, "trivial_outer_bitwise": True,
                     "losses": plain_losses.tolist()}}

    # nesterov and momentum: each boundary against the plain outer step
    for kind, kw in WIN_OUTER.items():
        t = _win_trainer(port, p0, s0, outer_opt=kind, **plain, **kw)
        seen = {}
        real_sync = tr.sync_grads

        def capture(strategy, mesh, grads, sync_state=None, call=None):
            new = real_sync(strategy, mesh, grads, sync_state, call)
            seen["d"] = [g.detach().clone() for g in grads]
            return new

        leaves = [t.params[k][n] for k, n in names]
        checks = []

        def before():
            seen["a"] = [tr._to_jax_layout(x.detach()).clone()
                         for x in leaves]
            seen["m"] = t.sync_state.clone()

        def after():
            m_flat, off, ok = t.sync_state, 0, True
            for x, a, d in zip(leaves, seen["a"], seen["d"]):
                size = a.numel()
                m = seen["m"][off:off + size].view(a.shape)
                wa, wm = _plain_outer(kind, kw["outer_momentum"],
                                      kw["outer_lr"], a,
                                      tr._to_jax_layout(d), m)
                ok &= torch.equal(tr._to_jax_layout(x.detach()), wa) and \
                    torch.equal(m_flat[off:off + size].view(a.shape), wm)
                off += size
            checks.append(ok and off == m_flat.numel())
            before()

        tr.sync_grads = capture
        try:
            before()
            _win_run(torch, t, images, labels, on_boundary=after)
        finally:
            tr.sync_grads = real_sync
        if not (len(checks) == WIN_STEPS // WIN_H and all(checks)):
            fail(f"(a) {kind}: the anchor or outer momentum after a "
                 f"boundary is not the plain outer step: {checks}")
        res[kind] = {"boundaries_bitwise": checks, **kw,
                     "outer_momentum_max_abs":
                         t.sync_state.abs().max().item()}
        del t

    # momentum SGD in bf16 against each strategy's per-step run
    for name, kw in WIN_MOMENTUM.items():
        strategy = name.split("_int")[0]
        runs = {}
        for h in (WIN_H, 1):
            t = _win_trainer(port, p0, s0, strategy=strategy,
                             compute_dtype="bfloat16", sync_every=h,
                             max_sync_every=h, **kw)
            runs[h] = (_win_run(torch, t, images, labels), t.sync_state)
            del t
        win, per = runs[WIN_H][0], runs[1][0]
        first_rel = abs(win[0].item() - per[0].item()) / abs(per[0].item())
        curve_rel = ((win - per).abs() / per.abs()).max().item()
        residual = runs[WIN_H][1]
        finite = bool(torch.isfinite(residual).all())
        if not (first_rel <= 1e-5 and curve_rel <= 1e-1 and finite
                and bool(torch.isfinite(win).all())):
            fail(f"(a) {name}: the window's losses {win.tolist()} against "
                 f"the per-step run's {per.tolist()} (step 0 {first_rel}, "
                 f"curve {curve_rel}), residual finite {finite}")
        res[name] = {"dtype": "bfloat16", "step0_rel": first_rel,
                     "curve_max_rel": curve_rel,
                     "window_losses": win.tolist(),
                     "per_step_losses": per.tolist(),
                     "residual_len": residual.numel(),
                     "residual_finite": finite}
    out["a"] = {**res, "seconds": time.perf_counter() - t0}
    print("  (a) VGG-11 windows of 4 steps: " + json.dumps(out["a"]))

    # (b) the exchange runs once a window
    t0 = time.perf_counter()
    bf16 = dict(strategy="ddp", compute_dtype="bfloat16")
    trainers = {h: _win_trainer(port, p0, s0, sync_every=h,
                                max_sync_every=h, **bf16)
                for h in (WIN_H, 1)}
    backend = torch.distributed.get_backend()
    calls = {}
    for h, t in trainers.items():
        _win_run(torch, t, images, labels)  # warm
        sync(torch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _win_run(torch, t, images, labels)
            sync(torch)
        calls[h] = dp_calls(prof, backend)
    n_calls = WIN_STEPS // WIN_H  # train_steps calls, each one loss sum
    grad_syncs = {h: calls[h]["calls"].get(f"{backend}:all_reduce", 0)
                  - n_calls for h in calls}
    if grad_syncs[WIN_H] != WIN_STEPS // WIN_H or grad_syncs[1] != WIN_STEPS:
        fail(f"(b) gradient all-reduces: {grad_syncs} (want "
             f"{WIN_STEPS // WIN_H} windowed, {WIN_STEPS} per step): "
             f"{calls}")
    ms = {h: [] for h in trainers}
    step_of = {h: 0 for h in trainers}

    def advance(h, k):
        t = trainers[h]
        for _ in range(k // WIN_H):
            i = step_of[h] % (WIN_WINDOW // WIN_H) * WIN_H
            t.train_steps(images[i:i + WIN_H], labels[i:i + WIN_H])
            step_of[h] += 1

    for _ in range(2):
        for h in (WIN_H, 1, 1, WIN_H):
            sync(torch)
            t1 = time.perf_counter()
            advance(h, WIN_WINDOW)
            sync(torch)
            ms[h].append((time.perf_counter() - t1) / WIN_WINDOW * 1e3)
    idle = {}
    for h in trainers:
        prof = profile(activities=[ProfilerActivity.CUDA])
        sync(torch)
        t1 = time.perf_counter()
        with prof:
            advance(h, WIN_STEPS)
            sync(torch)
        wall = (time.perf_counter() - t1) / WIN_STEPS * 1e3
        device_us = sum(e.self_device_time_total for e in
                        prof.key_averages() if e.device_type.name == "CUDA")
        idle[h] = {"device_ms_per_step": device_us / 1e3 / WIN_STEPS,
                   "profiled_wall_ms_per_step": wall,
                   "device_idle_share": 1.0 - device_us / 1e3 / WIN_STEPS
                   / wall}
    del trainers
    out["b"] = {"calls": {f"H={h}": c["calls"] for h, c in
                               calls.items()},
                "gradient_all_reduces": {f"H={h}": v for h, v in
                                         grad_syncs.items()},
                "ms_per_step_windows": {f"H={h}": v for h, v in ms.items()},
                "H4_over_H1_ms": float(np.median(ms[WIN_H])
                                       / np.median(ms[1])),
                "profiled": {f"H={h}": v for h, v in idle.items()},
                "seconds": time.perf_counter() - t0}
    print(f"  (b) ddp, {WIN_STEPS} steps at H={WIN_H} and H=1: "
          + json.dumps(out["b"]) + f"; {facts['smi']}")
    port["parallel_init"].shutdown()
    torch.backends.cudnn.deterministic = det

    # (c) the LM window arithmetic at LM-base width
    t0 = time.perf_counter()
    shapes = lm.param_shapes(lm_base_bytes(port))
    lnames = lm.jax_order(shapes)
    g = torch.Generator(device=DEVICE).manual_seed(23)
    anchor = [torch.randn(shapes[n], generator=g, device=DEVICE) * 0.02
              for n in lnames]
    delta = [torch.randn(shapes[n], generator=g, device=DEVICE) * 1e-4
             for n in lnames]
    m = [torch.randn(shapes[n], generator=g, device=DEVICE) * 1e-4
         for n in lnames]
    n_el = sum(x.numel() for x in anchor)
    outer = st.OuterOptimizer("nesterov", 0.9, 1.0)
    add_ms = time_ms(torch, lambda: [a + d for a, d in zip(anchor, delta)],
                     iters=10, warmup=2)
    apply_ms = time_ms(torch, lambda: outer.apply(anchor, delta, m),
                       iters=5, warmup=1)
    bad = []
    for n in WIN_LM_LEAVES:
        i = lnames.index(n)
        ga, gm = outer.apply([anchor[i]], [delta[i]], [m[i]])
        ca, cm = outer.apply([anchor[i].cpu()], [delta[i].cpu()],
                             [m[i].cpu()])
        if not (torch.equal(ga[0].cpu(), ca[0])
                and torch.equal(gm[0].cpu(), cm[0])):
            bad.append(("apply", n))
        # a replicated leaf and a ZeRO-3 leaf's prescale, over 2 slices of 4
        scales = lm.window_prescales(2, 4, [None, 0])
        for keep in (1.0, 0.0, None):
            gp = lm.window_prescale([delta[i]] * 2, scales, keep)
            cp = lm.window_prescale([delta[i].cpu()] * 2, scales, keep)
            if not all(torch.equal(x.cpu(), y) for x, y in zip(gp, cp)):
                bad.append(("prescale", n, keep))
            if keep == 0.0 and any(x.any() for x in gp):
                bad.append(("mask", n))
    if bad:
        fail(f"(c) the window arithmetic differs from the CPU's: {bad}")
    bw = facts["bw"]
    out["c"] = {"params": n_el, "dtype": "float32",
                "anchor_plus_delta": {
                    "ms": add_ms, "bytes": 12 * n_el,
                    "bound_ms": 12 * n_el / bw * 1e3,
                    "per": "local step"},
                "outer_apply_nesterov": {
                    "ms": apply_ms, "bytes": 20 * n_el,
                    "bound_ms": 20 * n_el / bw * 1e3, "per": "boundary"},
                "bitwise_cpu": list(WIN_LM_LEAVES),
                "seconds": time.perf_counter() - t0}
    del anchor, delta, m
    torch.cuda.empty_cache()
    print("  (c) the LM window arithmetic at LM-base width: "
          + json.dumps(out["c"]) + f"; {facts['smi']}")
    return out


# -- phase 23: observability (slice 5c-i) -----------------------------------

OBS_STEPS = 12    # (a): lm_cli steps; its --profile-dir traces steps 2-11
OBS_PROFILED = 10
OBS_K = 4         # (b): train_steps of K stacked batches
OBS_WINDOW = 10   # (c): steps a window, telemetry off / on, A B B A
# (c): steps of each profiled window (key_averages), each opened by
# utils/tracing.py start_profile, whose warm-up cycle keeps the first
# operations (a window opened plainly was seen to miss up to ~70)
OBS_PROFILE = 6
STEP_MARK = "spin_kernel"  # torch.cuda._sleep's kernel, between steps


def mark_step(torch) -> None:
    """Launch a one-thread kernel that does nothing (``torch.cuda._sleep(0)``)
    whose record marks a step boundary in a profiled window; the counts
    below leave it out."""
    torch.cuda._sleep(0)


def profiled_steps(prof) -> dict:
    """A profiled window's device operations, the step marks left out:
    ``ops`` and ``copies`` (device-to-host) in all, and each step's count
    between marks (``ops_by_step``, ``copies_by_step``).  The profiler can
    lose a run of records from a window, without a warning (up to a
    step's worth); every step runs the same operations, so the most
    common count of a step (``ops_step``, ``copies_step``) is a whole
    step's while most steps lost nothing (ties: the larger)."""
    from collections import Counter
    from torch.autograd import DeviceType
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    ops, copies, cur = [], [], None
    for e in evs:
        if STEP_MARK in e.name:
            cur = None
            continue
        if cur is None:
            ops.append(0)
            copies.append(0)
            cur = len(ops) - 1
        ops[cur] += 1
        copies[cur] += e.name.startswith("Memcpy DtoH")

    def mode(xs):
        c = Counter(xs)
        top = max(c.values(), default=0)
        return max((x for x, n in c.items() if n == top), default=0)
    return {"ops": sum(ops), "copies": sum(copies), "ops_by_step": ops,
            "copies_by_step": copies, "ops_step": mode(ops),
            "copies_step": mode(copies)}


def _trace_kernel_counts(trace_dir: str) -> dict:
    """Kernel launches by name in the torch.profiler Chrome trace(s) under
    ``trace_dir``: the K2/K3/K4 instances and the total."""
    import os
    counts = {k: 0 for k in SM90_KERNELS}
    total, n_files = 0, 0
    for name in os.listdir(trace_dir):
        if not name.endswith(".pt.trace.json"):
            continue
        n_files += 1
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        for e in events:
            if e.get("cat") != "kernel":
                continue
            total += 1
            for k, fn in SM90_KERNELS.items():
                if fn in e.get("name", ""):
                    counts[k] += 1
    return {"files": n_files, "kernels": total, **counts}


def _obs_batches(port, n: int, seed: int = 23) -> list:
    corpus_mod = port["corpus"]
    corpus = corpus_mod.load_corpus(None)
    loader = corpus_mod.LMDataLoader(corpus, 8, 1024, seed=seed)
    return [bt for _, bt in zip(range(n), loader)]


def _obs_state(trainer) -> tuple:
    """Copies of the trainer's params and Adam state (load_state's form)."""
    p = {n: t.detach().clone() for n, t in trainer.params.items()}
    o = {"count": trainer.opt_state["count"],
         **{m: {n: t.clone() for n, t in trainer.opt_state[m].items()}
            for m in ("mu", "nu")}}
    return p, o


def _max_gap(torch, a: dict, b: dict) -> float:
    return max((x.float() - b[n].float()).abs().max().item()
               for n, x in a.items())


def observability_phase(torch, port, facts, phase8_ops: int) -> dict:
    """Phase 23: the observability layer (slice 5c-i) at LM-base width,
    bf16, B=8 x S=1024.

    (a) ``lm_cli.run --steps 12 --telemetry-dir D --profile-dir P``: D
        holds rank 0's file, epoch first; 12 ``lm_train_step`` spans and 12
        each of the loss / grad_norm / param_norm gauges, the loss gauges
        bitwise the losses the run's ``on_step`` hook fetched; the merged
        trace strict JSON and the summary's 12 steps; P's profiler trace
        holds K2, K3 and K4 24 x 10 times each (steps 2-11).  Both
        directories are temporary and deleted after.
    (b) ``LMTrainer.train_steps`` of K=4 stacked batches against four
        ``train_step`` calls from the same state: losses and params
        bitwise (or, where two runs of the four calls already differ,
        within that repeat's largest gap).
    (c) telemetry off and on in 10-step windows from one state, A B B A
        (ms a step), and CUDA-profiled 6-step windows apart, A B B A
        (device ops a step, each window's most common step's, and idle
        share from each side's fuller window): the losses bitwise on and
        off; telemetry off adds no device operation to phase 8's step and
        makes no device-to-host copy, on makes one a step.
    (d) ``record_memory`` on the trainer's params and Adam state: its
        ``device_peak_bytes`` is ``torch.cuda.max_memory_allocated()``,
        its tree bytes ``numel x element_size`` summed.
    (e) ``evaluate_run(D)`` with a ``step_time`` p95 rule under the
        measured p95 breaches, one over it does not."""
    import os
    import shutil
    import tempfile
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    attn, cli, lm = port["attn"], port["lm_cli"], port["lm"]
    tel_mod, mon = port["telemetry"], port["monitor"]
    tracing = port["tracing"]
    b, s = 8, 1024
    model = lm_base_bytes(port)
    n_layers = model.n_layers
    out = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        run_dir, prof_dir = os.path.join(tmp, "run"), os.path.join(tmp,
                                                                   "prof")
        # (a)
        losses = []
        for f in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            getattr(attn, f).launches = 0
        t0 = time.perf_counter()
        cli.run(["--preset", "LM-base", "--steps", str(OBS_STEPS),
                 "--batch-size", str(b), "--seq-len", str(s),
                 "--compute-dtype", "bfloat16", "--log-every", "100",
                 "--device", DEVICE, "--telemetry-dir", run_dir,
                 "--profile-dir", prof_dir],
                on_step=lambda step, tr, loss: losses.append(
                    loss.detach().clone()))
        launches = {"K2": attn.flash_attention_fwd.launches,
                    "K3": attn.flash_attention_bwd_dq.launches,
                    "K4": attn.flash_attention_bwd_dkv.launches}
        run_s = time.perf_counter() - t0
        losses = [float(x) for x in losses]
        files = sorted(os.listdir(run_dir))
        if len(files) != 1 or not files[0].startswith("events_rank0_gen0_"):
            fail(f"(a) the run directory holds {files}, want rank 0's file")
        with open(os.path.join(run_dir, files[0])) as f:
            first = json.loads(f.readline())
        if first.get("type") != "epoch":
            fail(f"(a) the first record is {first}, not the epoch")
        (_, recs), = tel_mod.read_run(run_dir)
        by = {}
        for r in recs:
            by.setdefault((r["type"], r["name"]), []).append(r)
        spans = by.get(("span", "lm_train_step"), [])
        counts = {n: len(by.get(("gauge", n), []))
                  for n in ("loss", "grad_norm", "param_norm")}
        if len(spans) != OBS_STEPS or set(counts.values()) != {OBS_STEPS}:
            fail(f"(a) {len(spans)} step spans and gauges {counts}, want "
                 f"{OBS_STEPS} each")
        gauged = [r["value"] for r in by[("gauge", "loss")]]
        if gauged != losses:
            fail(f"(a) the loss gauges {gauged} are not the losses the "
                 f"run returned {losses}")
        trace = tel_mod.merge_chrome_trace(run_dir)
        json.loads(json.dumps(trace, allow_nan=False))  # strict JSON
        summary = tel_mod.run_summary(run_dir)
        if summary["counters"].get("rank0/train/steps") != OBS_STEPS:
            fail(f"(a) run_summary counts {summary['counters']}")
        t0 = time.perf_counter()
        kern = _trace_kernel_counts(prof_dir)
        parse_s = time.perf_counter() - t0
        trace_mb = sum(os.path.getsize(os.path.join(prof_dir, n))
                       for n in os.listdir(prof_dir)) / 1e6
        want = n_layers * OBS_PROFILED
        traces = [kern]
        if kern["files"] == 1 and any(kern[k] != want for k in SM90_KERNELS):
            # the profiler has lost a run of kernel records from a trace
            # (66-67 of 47,680, K2 239, in two whole runs of this script):
            # trace the same steps once more, through lm_cli alone
            shutil.rmtree(prof_dir)
            cli.run(["--preset", "LM-base", "--steps", str(OBS_STEPS),
                     "--batch-size", str(b), "--seq-len", str(s),
                     "--compute-dtype", "bfloat16", "--log-every", "100",
                     "--device", DEVICE, "--profile-dir", prof_dir])
            kern = _trace_kernel_counts(prof_dir)
            traces.append(kern)
        if kern["files"] != 1 or any(kern[k] != want for k in SM90_KERNELS):
            fail(f"(a) the profiler traces hold {traces}, want one file "
                 f"with {want} launches each of K2, K3, K4")
        if any(n != n_layers * OBS_STEPS for n in launches.values()):
            fail(f"(a) {launches} launches in {OBS_STEPS} steps")
        step = summary["spans"]["rank0/train/lm_train_step"]
        out["a"] = {
            "steps": OBS_STEPS, "run_s": run_s, "launches": launches,
            "profiled_steps": OBS_PROFILED, "trace_kernels": kern,
            "traces": len(traces), "first_trace_kernels": traces[0],
            "trace_mb": trace_mb, "trace_parse_s": parse_s,
            "records": len(recs), "merged_trace_events":
                len(trace["traceEvents"]),
            "step_span_ms": {"p50": step["p50_s"] * 1e3,
                             "p95": step["p95_s"] * 1e3,
                             "max": step["max_s"] * 1e3},
            "compile_spans": {k: v["count"] for k, v in
                              summary["spans"].items() if "/compile/" in k}}
        print("  (a) lm_cli with --telemetry-dir and --profile-dir: "
              + json.dumps(out["a"]))
        # (e), on (a)'s run directory
        p95_ms = step["p95_s"] * 1e3
        rules = [mon.SloRule(name="under", metric="lm_train_step",
                             threshold=p95_ms * 0.5, agg="p95",
                             severity="critical"),
                 mon.SloRule(name="over", metric="lm_train_step",
                             threshold=p95_ms * 2.0, agg="p95")]
        st = mon.evaluate_run(run_dir, rules)
        if not st["under"]["breached"] or st["over"]["breached"]:
            fail(f"(e) evaluate_run: {st}")
        out["e"] = {"measured_p95_ms": p95_ms,
                    "rules": {k: {"threshold_ms": v["rule"]["threshold"],
                                  "current_ms": v["current"],
                                  "breached": v["breached"],
                                  "samples": v["samples"]}
                              for k, v in st.items()}}
        print("  (e) evaluate_run step_time p95 rules: "
              + json.dumps(out["e"]))

        # (b)
        cfg = lm.LMTrainConfig(model=model, compute_dtype="bfloat16")
        tr = lm.LMTrainer(cfg, device=DEVICE)
        batches = _obs_batches(port, max(OBS_K, OBS_WINDOW))
        tk = np.stack([x[0] for x in batches[:OBS_K]])
        tg = np.stack([x[1] for x in batches[:OBS_K]])
        p0, o0 = _obs_state(tr)
        got = tr.train_steps(tk, tg)
        many = ([float(x) for x in got], _obs_state(tr)[0],
                tr.last_metrics.float().cpu().numpy().tolist())
        singles = []
        for _ in range(2):
            tr.load_state(p0, o0)
            ls = [float(tr.train_step(*bt)) for bt in batches[:OBS_K]]
            singles.append((ls, _obs_state(tr)[0]))
        repeat_gap = max(_max_gap(torch, singles[0][1], singles[1][1]),
                         max(abs(x - y) for x, y in zip(singles[0][0],
                                                        singles[1][0])))
        gap = max(_max_gap(torch, many[1], singles[0][1]),
                  max(abs(x - y) for x, y in zip(many[0], singles[0][0])))
        if not gap <= repeat_gap:
            fail(f"(b) train_steps differs from {OBS_K} train_step calls "
                 f"by {gap} (the calls' own repeat: {repeat_gap})")
        out["b"] = {"k": OBS_K, "losses": many[0],
                    "losses_train_step": singles[0][0],
                    "max_gap": gap, "repeat_gap": repeat_gap,
                    "bitwise": gap == 0.0, "last_metrics": many[2]}
        print("  (b) train_steps(K=4) against 4 train_step calls: "
              + json.dumps(out["b"]))

        # (c)
        win = batches[:OBS_WINDOW]

        def window(on: bool, profiled: bool = False):
            tr.load_state(p0, o0)
            steps = win[:OBS_PROFILE] if profiled else win
            prof = None
            if on:
                tel_mod.enable(os.path.join(tmp, "windows"), rank=0)
            try:
                sync(torch)
                if profiled:
                    prof = tracing.start_profile([ProfilerActivity.CUDA])
                t0 = time.perf_counter()
                ls = []
                for i, bt in enumerate(steps):
                    if profiled and i:
                        mark_step(torch)
                    ls.append(tr.train_step(*bt))
                sync(torch)
                dt = time.perf_counter() - t0
                if prof is not None:
                    tracing.stop_profile(prof)
            finally:
                tel_mod.disable()
            return [float(x) for x in ls], dt / len(steps) * 1e3, prof

        ms = {"off": [], "on": []}
        seen = {}
        for mode in ("off", "on", "on", "off"):
            ls, m, _ = window(mode == "on")
            ms[mode].append(m)
            seen.setdefault(mode, []).append(ls)
        # two profiled windows a side, A B B A, a step mark between two
        # steps: a profiled window can lose a run of records (72, a step's
        # worth, of 6 steps; 30 of phase 8's 5), so the counts a step are
        # each window's most common step's (profiled_steps) and each side
        # reads its fuller window
        prof_res, windows = {}, {"off": [], "on": []}
        for mode in ("off", "on", "on", "off"):
            ls, m, prof = window(mode == "on", profiled=True)
            seen[mode].append(ls)
            dev_us = sum(e.self_device_time_total
                         for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA
                         and STEP_MARK not in e.key)
            st = profiled_steps(prof)
            windows[mode].append({
                "steps": OBS_PROFILE, "ms_per_step_profiled": m,
                "device_ms_per_step": dev_us / 1e3 / OBS_PROFILE,
                "device_ops_per_step": st["ops"] / OBS_PROFILE,
                "device_ops_step": st["ops_step"],
                "device_ops_by_step": st["ops_by_step"],
                "device_to_host_copies": st["copies"],
                "device_to_host_copies_step": st["copies_step"],
                "device_idle_share": 1.0 - dev_us / 1e3 / OBS_PROFILE / m})
        for mode, ws in windows.items():
            prof_res[mode] = dict(max(ws, key=lambda w: w["device_ops"
                                                         "_per_step"]),
                                  windows_ops_step=[w["device_ops_step"]
                                                    for w in ws],
                                  windows_copies=[w["device_to_host_copies"]
                                                  for w in ws])
        runs = seen["off"] + seen["on"]  # for the failure message
        off_spread = max(abs(x - y) for r in seen["off"][1:]
                         for x, y in zip(r, seen["off"][0]))
        on_gap = max(abs(x - y) for r in seen["on"]  # zip: 6 or 10 steps
                     for x, y in zip(r, seen["off"][0]))
        if not on_gap <= off_spread:
            fail(f"(c) losses with telemetry on differ from off by {on_gap} "
                 f"(off against off: {off_spread}): {runs}")
        # Telemetry's operations are a concatenation and a device-to-host
        # copy a step: with it off the windows hold no such copy, with it
        # on one a step.  Off, a step runs no more operations than phase
        # 8's step (each the most common step of its window).
        pr = prof_res
        if any(pr["off"]["windows_copies"]) or max(
                w["device_to_host_copies_step"] for w in windows["on"]) != 1:
            fail(f"(c) device-to-host copies off / on: {pr}")
        if not pr["off"]["device_ops_step"] <= phase8_ops:
            fail(f"(c) telemetry off runs {pr['off']} device operations a "
                 f"step, phase 8 {phase8_ops}")
        med = {k: float(np.median(v)) for k, v in ms.items()}
        out["c"] = {"window_steps": OBS_WINDOW, "order": "off on on off",
                    "ms_per_step": ms, "ms_median": med,
                    "on_over_off_ms": med["on"] / med["off"],
                    "profiled": prof_res,
                    "phase8_device_ops_step": phase8_ops,
                    "added_device_ops_per_step":
                        prof_res["on"]["device_ops_step"]
                        - prof_res["off"]["device_ops_step"],
                    "losses_bitwise_on_off": on_gap == 0.0,
                    "loss_gap_on_off": on_gap, "loss_spread_off": off_spread}
        print("  (c) telemetry off / on windows: " + json.dumps(out["c"])
              + f"; {facts['smi']}")

        # (d)
        tel_mod.enable(os.path.join(tmp, "mem"), rank=0)
        try:
            wm = mon.record_memory(params=tr.params, opt=tr.opt_state)
            peak = torch.cuda.max_memory_allocated()
        finally:
            tel_mod.disable()
        (_, mrecs), = tel_mod.read_run(os.path.join(tmp, "mem"))
        g = {r["name"]: r["value"] for r in mrecs}
        want_p = sum(t.numel() * t.element_size()
                     for t in tr.params.values())
        want_o = sum(t.numel() * t.element_size()
                     for m in ("mu", "nu") for t in tr.opt_state[m].values())
        if g.get("device_peak_bytes") != peak or \
                g.get("params_bytes") != want_p or \
                g.get("opt_bytes") != want_o:
            fail(f"(d) record_memory gave {g}; max_memory_allocated "
                 f"{peak}, params {want_p}, optimizer {want_o}")
        out["d"] = {"gauges": g, "max_memory_allocated": peak,
                    "devices": wm["devices"]}
        print("  (d) record_memory: " + json.dumps(out["d"]))
    del tr
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 23 took {out['seconds']:.1f} s")
    return out


# -- phase 24: checkpoints and faults (slice 5c-ii) -------------------------

CKPT_STEPS = 30          # (a): phase 8's run, crashed and resumed
CKPT_EVERY = 10
CKPT_CRASH = 15          # (a): the generation-0 crash step
CKPT_LAYERS = 4          # (b), (c): LM-base width, 4 layers
SENTRY_WINDOW = 10       # (b): steps a window, sentry off / on, A B B A
POISON_OPS = 1           # (d): a fired nan_grad tap's device operations

# One rank of phase 24 (a)'s gang (launch.py --max-restarts 1): lm_cli.run
# with the given argv; K2-K4's launches, the losses as float hex, each
# save call's ms (the step loop's stall) and its synchronous fetch's ms
# (utils/checkpoint._flatten), and the restored meta.  A generation the
# crash plan kills prints nothing.
CKPT_CHILD = r"""
import json, os, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from distributed_pytorch_tpu_torch import lm, lm_cli
from distributed_pytorch_tpu_torch.ops import attention as attn
from distributed_pytorch_tpu_torch.utils import checkpoint as ck
fns = ("flash_attention_fwd", "flash_attention_bwd_dq",
       "flash_attention_bwd_dkv")
for f in fns:
    getattr(attn, f).launches = 0
losses, save_ms, fetch_ms, start = [], [], [], []
save, flatten = lm.LMTrainer.save_checkpoint, ck._flatten
def timed_save(self, *a, **k):
    t0 = time.perf_counter()
    save(self, *a, **k)
    save_ms.append((time.perf_counter() - t0) * 1e3)
def timed_flatten(*a, **k):
    t0 = time.perf_counter()
    out = flatten(*a, **k)
    fetch_ms.append((time.perf_counter() - t0) * 1e3)
    return out
lm.LMTrainer.save_checkpoint, ck._flatten = timed_save, timed_flatten
def on_step(step, trainer, loss):
    if not start:
        start.append(step - 1)
    losses.append(loss.detach().clone())
tr = lm_cli.run(json.loads(sys.argv[1]), on_step=on_step)
print("CKPT " + json.dumps({
    "attempt": int(os.environ.get("RESTART_ATTEMPT", "0")),
    "start": start[0] if start else None, "steps": len(losses),
    "restored_step": tr.restored_meta.get("step"),
    "restored_loader": tr.restored_meta.get("loader"),
    "losses": [float(x).hex() for x in losses],
    "launches": {k: getattr(attn, f).launches
                 for k, f in zip(("K2", "K3", "K4"), fns)},
    "save_call_ms": save_ms, "fetch_ms": fetch_ms}), flush=True)
"""


def _ckpt_gang(argv: list[str], env: dict, run_dir: str,
               timeout_s: float = 600.0):
    """``launch.py --nproc-per-node 1 --max-restarts 1 --telemetry-dir
    run_dir`` running CKPT_CHILD over ``argv`` with ``env`` added, in a
    session of its own (killed whole on a timeout); its exit code and
    output."""
    import os
    import signal
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_pytorch_tpu_torch.launch",
         "--nproc-per-node", "1", "--max-restarts", "1", "--master-port",
         str(free_port()), "--telemetry-dir", run_dir, "--", "-c",
         CKPT_CHILD, json.dumps(argv)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True, env=dict(os.environ, **env),
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        text, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"(a) the crashed gang did not finish in {timeout_s} s")
    return proc.returncode, text


def _host_state(tr) -> dict:
    """Host copies of an LM trainer's params and Adam moments, and its
    step count."""
    return {"count": tr.opt_state["count"], "step": tr._step,
            **{f"{m}/{n}": t.detach().float().cpu().clone()
               for m, tree in (("p", tr.params), ("mu", tr.opt_state["mu"]),
                               ("nu", tr.opt_state["nu"]))
               for n, t in tree.items()}}


def _same_state(torch, a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(v, b[k]) if hasattr(v, "shape") else v == b[k]
        for k, v in a.items())


def checkpoint_phase(torch, port, facts, phase8: dict) -> dict:
    """Phase 24: checkpoints and faults (slice 5c-ii) at LM-base width,
    bf16, B=8 x S=1024.

    (a) The main path: ``launch.py --nproc-per-node 1 --max-restarts 1``
        over lm_cli with phase 8's flags and ``--steps 30
        --checkpoint-dir D --checkpoint-every 10 --telemetry-dir T``,
        ``FAULT_PLAN`` a crash at step 15 in generation 0.  The launcher
        sees one injected fault and restarts once; generation 1 restores
        step 10 (its loader position too) and trains steps 11-30, whose
        loss gauges in T are bitwise phase 8's, with K2-K4 once per layer
        per step.  Reports each save's bytes, its synchronous fetch (the
        step loop's stall), the background write's ms, the restore's ms
        (read and verified), and the disk's free bytes before.  D and T
        are deleted after.
    (b) The training sentry, 4 layers in-process: ``nan_grad`` and
        ``inf_grad`` at step 4 and a 1e6 ``loss_spike`` at step 5, each
        rolled back and its window skipped, the params and Adam state
        bitwise a clean run's without that window and the stats the
        predicted ones; a persistent ``nan_grad`` (count 3) tightens the
        clip, then aborts (``SentryAbort``) with a ``sentry_abort``
        postmortem; a snapshot's ms, and sentry off / on ms a step in
        A B B A windows.
    (c) Corruption, 4 layers: a ``ckpt_corrupt`` plan (bitflip, truncate)
        on the whole-tree and the sharded format at world size 1: the
        corrupt generation is quarantined and the restore is bitwise the
        previous save.
    (d) No plan, no cost: LM-base (24 layers) in profiled windows read as
        phase 23 (c) reads them, the faults module loaded and no plan: a
        step's device operations equal phase 8's; with a ``nan_grad``
        plan the fired step adds only the poison's."""
    import dataclasses
    import os
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity
    from distributed_pytorch_tpu_torch.utils import checkpoint as ck
    from distributed_pytorch_tpu_torch.utils import faults, sentry
    lm, tel_mod, mon = port["lm"], port["telemetry"], port["monitor"]
    tracing = port["tracing"]
    out = {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()

    # (a)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt_dir, run_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp,
                                                                   "tel")
        free = shutil.disk_usage(tmp).free
        argv = ["--preset", "LM-base", "--steps", str(CKPT_STEPS),
                "--batch-size", "8", "--seq-len", "1024", "--compute-dtype",
                "bfloat16", "--log-every", "10", "--device", DEVICE,
                "--checkpoint-dir", ckpt_dir, "--checkpoint-every",
                str(CKPT_EVERY), "--telemetry-dir", run_dir]
        plan = faults.FaultPlan(kind="crash", step=CKPT_CRASH, gen=0)
        t0 = time.perf_counter()
        rc, text = _ckpt_gang(argv, {faults.ENV_VAR: plan.to_env()},
                              run_dir)
        run_s = time.perf_counter() - t0
        lines = [json.loads(x[5:]) for x in text.splitlines()
                 if x.startswith("CKPT ")]
        if rc != 0 or len(lines) != 1:
            fail(f"(a) the gang exited {rc} with {len(lines)} result "
                 f"line(s):\n{text[-4000:]}")
        child = lines[0]
        if text.count("(injected fault)") != 1 or \
                f"injected crash at step {CKPT_CRASH}" not in text:
            fail(f"(a) want one injected crash at step {CKPT_CRASH}:\n"
                 f"{text[-4000:]}")
        n_steps = CKPT_STEPS - CKPT_EVERY
        n_layers = lm_base_bytes(port).n_layers
        if (child["attempt"], child["restored_step"], child["start"],
                child["steps"]) != (1, CKPT_EVERY, CKPT_EVERY, n_steps):
            fail(f"(a) generation 1 ran {child}, want attempt 1 restoring "
                 f"step {CKPT_EVERY} and running {n_steps} steps")
        if any(n != n_layers * n_steps for n in child["launches"].values()):
            fail(f"(a) {child['launches']} launches in {n_steps} steps of "
                 f"{n_layers} layers")
        runs = {(ep["rank"], ep["gen"]): recs
                for ep, recs in tel_mod.read_run(run_dir)}
        gen1 = runs.get((0, 1), [])
        gauged = {r["args"]["step"]: r["value"] for r in gen1
                  if r["type"] == "gauge" and r["name"] == "loss"}
        want = phase8["losses"][CKPT_EVERY:CKPT_STEPS]
        got = [gauged.get(s) for s in range(CKPT_EVERY, CKPT_STEPS)]
        child_losses = [float.fromhex(x) for x in child["losses"]]
        if got != child_losses:
            fail(f"(a) the loss gauges {got} are not the losses generation "
                 f"1 returned {child_losses}")
        if got != want:
            fail(f"(a) steps {CKPT_EVERY + 1}-{CKPT_STEPS} after the resume "
                 f"{got} are not phase 8's {want}")
        agent = runs.get((-1, 0), [])
        done = [r for r in agent if r.get("name") == "gang_done"]
        exits = [r for r in agent if r.get("name") == "worker_exit"]
        if len(done) != 1 or done[0]["args"].get("restarts_used") != 1 or \
                [r["args"].get("kind") for r in exits] != ["injected fault"]:
            fail(f"(a) the agent's events: {done} {exits}")
        spans = [r for r in gen1 if r["type"] == "span"
                 and r["name"] in ("ckpt_save", "ckpt_restore")]
        saves = [{"step": r["args"]["step"], "bytes": r["args"]["bytes"],
                  "write_ms": r["dur"] * 1e3} for r in spans
                 if r["name"] == "ckpt_save"]
        restore = [{"step": r["args"]["step"], "bytes": r["args"]["bytes"],
                    "ms": r["dur"] * 1e3} for r in spans
                   if r["name"] == "ckpt_restore"]
        if [s["step"] for s in saves] != [20, 30, 30] or \
                [r["step"] for r in restore] != [CKPT_EVERY]:
            fail(f"(a) generation 1's checkpoint spans: {saves} {restore}")
        out["a"] = {
            "steps": CKPT_STEPS, "every": CKPT_EVERY, "crash": CKPT_CRASH,
            "run_s": run_s, "disk_free_bytes_before": free,
            "restored": {"step": child["restored_step"],
                         "loader": child["restored_loader"]},
            "losses_bitwise_phase8": True, "launches": child["launches"],
            "saves_gen1": saves, "restore_gen1": restore,
            "save_call_ms_gen1": child["save_call_ms"],
            "fetch_ms_gen1": child["fetch_ms"],
            "param_bytes": phase8["n_params"] * 4}
        print("  (a) crash at step 15, restart, resume from step 10: "
              + json.dumps(out["a"]) + f"; {facts['smi']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (b)
    model = dataclasses.replace(lm_base_bytes(port), n_layers=CKPT_LAYERS)

    def trainer():
        return lm.LMTrainer(lm.LMTrainConfig(model=model,
                                             compute_dtype="bfloat16"),
                            device=DEVICE)

    tr = trainer()
    batches = _obs_batches(port, 9)
    p0, o0 = _obs_state(tr)
    quiet = lambda *a: None  # noqa: E731

    def guarded(plan, cfg, n, t=tr):
        faults.reset()
        faults.install(plan)
        t.load_state(p0, o0)
        s = sentry.TrainingSentry(t, cfg, log=quiet)
        try:
            skipped = [i for i, bt in enumerate(batches[:n])
                       if s.step(*bt) is None]
        finally:
            faults.reset()
        return skipped, dict(s.stats), _host_state(t)

    def clean(skip, n):
        tr.load_state(p0, o0)
        for i, bt in enumerate(batches[:n]):
            if i not in skip:
                tr.train_step(*bt)
        return _host_state(tr)

    spike_cfg = sentry.SentryConfig(checkpoint_every=2, spike_window=8,
                                    spike_threshold=1000.0,
                                    spike_min_history=3)
    cases = {
        "nan_grad": (faults.FaultPlan(kind="nan_grad", step=4, seed=3),
                     sentry.SentryConfig(checkpoint_every=2), 8, [4],
                     dict(steps=7, nonfinite=1, rollbacks=1,
                          skipped_steps=1, snapshots=4)),
        "inf_grad": (faults.FaultPlan(kind="inf_grad", step=4, seed=3),
                     sentry.SentryConfig(checkpoint_every=2), 8, [4],
                     dict(steps=7, nonfinite=1, rollbacks=1,
                          skipped_steps=1, snapshots=4)),
        "loss_spike": (faults.FaultPlan(kind="loss_spike", step=5,
                                        magnitude=1e6),
                       spike_cfg, 9, [5],
                       dict(steps=8, spikes=1, rollbacks=1, skipped_steps=2,
                            snapshots=4))}
    out["b"] = {}
    for kind, (plan, cfg, n, want_skip, want) in cases.items():
        skipped, stats, st = guarded(plan, cfg, n)
        want = dict(dict.fromkeys(stats, 0), **want)
        # the skipped window: the batches since the last snapshot
        window = set(range(want_skip[0] - want["skipped_steps"] + 1,
                           want_skip[0] + 1))
        ref = clean(window, n)
        if skipped != want_skip or stats != want:
            fail(f"(b) {kind}: skipped {skipped}, stats {stats}; want "
                 f"{want_skip}, {want}")
        if not _same_state(torch, st, ref):
            fail(f"(b) {kind}: the state after the rollback is not the "
                 f"clean run's without batches {sorted(window)}")
        out["b"][kind] = {"skipped": skipped, "stats": stats,
                          "bitwise_clean_without": sorted(window)}
    # a persistent fault: count 3 crossings of step 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sentry_") as rd:
        tel_mod.enable(rd, rank=0)
        t2 = trainer()
        try:
            guarded(faults.FaultPlan(kind="nan_grad", step=2, count=3),
                    sentry.SentryConfig(checkpoint_every=100, skip_budget=1,
                                        max_rollbacks=2), 9, t=t2)
            fail("(b) the persistent fault did not abort")
        except sentry.SentryAbort as e:
            abort = e.stats
        finally:
            tel_mod.disable()
        bundles = mon.find_postmortems(rd)
        kinds = [mon.load_postmortem(b)["trigger"]["kind"] for b in bundles]
        want = dict(dict.fromkeys(abort, 0), steps=6, nonfinite=3,
                    rollbacks=2, skipped_steps=6, clip_tightened=1,
                    snapshots=1)
        if abort != want or kinds != ["sentry_abort"] or \
                t2.cfg.grad_clip != 0.5:
            fail(f"(b) persistent fault: stats {abort} (want {want}), "
                 f"bundles {kinds}, clip {t2.cfg.grad_clip}")
        out["b"]["persistent"] = {"stats": abort, "bundles": kinds,
                                  "grad_clip": t2.cfg.grad_clip}
        del t2
    # a snapshot's ms, and the sentry's cost a step
    tr.load_state(p0, o0)
    s = sentry.TrainingSentry(tr, log=quiet)
    snap_ms = []
    for _ in range(3):
        sync(torch)
        t0 = time.perf_counter()
        s.snapshot()
        snap_ms.append((time.perf_counter() - t0) * 1e3)
    ms = {"off": [], "on": []}
    win = (batches * 2)[:SENTRY_WINDOW]
    for mode in ("off", "on", "on", "off"):
        tr.load_state(p0, o0)
        s = sentry.TrainingSentry(tr, log=quiet)  # its snapshot: untimed
        sync(torch)
        t0 = time.perf_counter()
        for bt in win:
            (s.step if mode == "on" else tr.train_step)(*bt)
        sync(torch)
        ms[mode].append((time.perf_counter() - t0) / len(win) * 1e3)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    snap_bytes = sum(t.numel() * 4 for t in tr.params.values()) * 3
    out["b"]["cost"] = {"layers": CKPT_LAYERS, "snapshot_ms": snap_ms,
                        "snapshot_bytes": snap_bytes,
                        "window_steps": SENTRY_WINDOW,
                        "order": "off on on off", "ms_per_step": ms,
                        "on_over_off_ms": med["on"] / med["off"]}
    print("  (b) the training sentry: " + json.dumps(out["b"])
          + f"; {facts['smi']}")

    # (c)
    out["c"] = {}
    for fmt in ("whole", "sharded"):
        # one good save at step 1, then each mode corrupts a step-2 save
        # (the second quarantine takes the name's next suffix)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cor_") as d:
            tr.load_state(p0, o0)
            tr.train_step(*batches[0])
            tr.save_checkpoint(d, sharded=fmt == "sharded")
            tr.flush_checkpoints()
            good = _host_state(tr)
            for n, mode in enumerate(("bitflip", "truncate")):
                tr.train_step(*batches[1])
                faults.install(faults.FaultPlan(kind="ckpt_corrupt", seed=11,
                                                mode=mode))
                try:
                    tr.save_checkpoint(d, sharded=fmt == "sharded")
                    tr.flush_checkpoints()
                finally:
                    faults.reset()
                tr.load_state(p0, o0)
                t0 = time.perf_counter()
                got = tr.maybe_restore(d)
                restore_ms = (time.perf_counter() - t0) * 1e3
                bad = os.path.join(d, ("ckpt_2.npz" if fmt == "whole"
                                       else "ckpt_2") + ".corrupt"
                                   + (f".{n}" if n else ""))
                if got != 1 or not os.path.exists(bad) or \
                        not _same_state(torch, _host_state(tr), good):
                    fail(f"(c) {fmt} {mode}: restored step {got}, "
                         f"quarantined {os.path.exists(bad)}, "
                         f"{sorted(os.listdir(d))}")
                out["c"][f"{fmt}_{mode}"] = {
                    "restored_step": got,
                    "quarantined": os.path.basename(bad),
                    "bitwise_previous_save": True,
                    "restore_ms_with_fallback": restore_ms}
    print("  (c) corrupt checkpoints quarantined, previous save restored: "
          + json.dumps(out["c"]))
    del tr
    torch.cuda.empty_cache()

    # (d)
    big = lm.LMTrainer(lm.LMTrainConfig(model=lm_base_bytes(port),
                                        compute_dtype="bfloat16"),
                       device=DEVICE)
    steps = _obs_batches(port, 6)
    q0, r0 = _obs_state(big)

    def profiled(plan):
        faults.reset()
        if plan is not None:
            faults.install(plan)
        try:
            big.load_state(q0, r0)
            sync(torch)
            prof = tracing.start_profile([ProfilerActivity.CUDA])
            for i, bt in enumerate(steps):
                if i:
                    mark_step(torch)
                big.train_step(*bt)
            sync(torch)
            tracing.stop_profile(prof)
        finally:
            faults.reset()
        return profiled_steps(prof)

    fire = faults.FaultPlan(kind="nan_grad", step=2, seed=0)
    plain = [profiled(None)]
    fired = [profiled(fire) for _ in range(2)]
    clean_ops = max(w["ops_step"] for w in plain)
    fired_ops = max((w["ops_by_step"][2] for w in fired
                     if len(w["ops_by_step"]) == len(steps)), default=-1)
    if clean_ops != phase8["device_ops_step"]:
        fail(f"(d) no plan: {clean_ops} device operations a step, phase 8 "
             f"{phase8['device_ops_step']}")
    if fired_ops - clean_ops != POISON_OPS or \
            max(w["ops_step"] for w in fired) != clean_ops:
        fail(f"(d) the fired step ran {fired_ops} device operations, the "
             f"others {[w['ops_by_step'] for w in fired]}; a clean step "
             f"{clean_ops}, the poison {POISON_OPS}")
    out["d"] = {"phase8_device_ops_step": phase8["device_ops_step"],
                "no_plan_device_ops_step": clean_ops,
                "no_plan_by_step": [w["ops_by_step"] for w in plain],
                "fired_step_device_ops": fired_ops,
                "fired_by_step": [w["ops_by_step"] for w in fired],
                "poison_ops": fired_ops - clean_ops}
    print("  (d) no plan, no cost: " + json.dumps(out["d"]))
    del big
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 24 took {out['seconds']:.1f} s")
    return out


T_START = time.perf_counter()


def phase(n: int, title: str) -> None:
    print(f"[{n}] {title} (at {time.perf_counter() - T_START:.0f} s)",
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from distributed_pytorch_tpu_torch import cli, lm, lm_cli, serve
        from distributed_pytorch_tpu_torch import generate as gen
        from distributed_pytorch_tpu_torch import train
        from distributed_pytorch_tpu_torch.data import cifar10, lm_corpus
        from distributed_pytorch_tpu_torch.models import transformer as tfm
        from distributed_pytorch_tpu_torch.models import vgg
        from distributed_pytorch_tpu_torch.ops import _build
        from distributed_pytorch_tpu_torch.ops import attention as attn
        from distributed_pytorch_tpu_torch.ops import fused_bn
        from distributed_pytorch_tpu_torch.ops import losses, moe, nn
        from distributed_pytorch_tpu_torch.ops import quantized as qz
        from distributed_pytorch_tpu_torch.parallel import init as pinit
        from distributed_pytorch_tpu_torch.parallel import mesh as pmesh
        from distributed_pytorch_tpu_torch.parallel import strategies
        from distributed_pytorch_tpu_torch.utils import (monitor, telemetry,
                                                          tracing)
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable: {e}",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F
    port = {"tfm": tfm, "gen": gen, "serve": serve, "attn": attn, "lm": lm,
            "lm_cli": lm_cli, "dev": "cuda", "cfg": tfm.PRESETS["LM-base"],
            "train": train, "cli": cli, "vgg": vgg, "fused_bn": fused_bn,
            "cifar10": cifar10, "nn": nn, "qz": qz, "losses": losses,
            "corpus": lm_corpus, "strategies": strategies, "mesh": pmesh,
            "parallel_init": pinit, "moe": moe, "telemetry": telemetry,
            "monitor": monitor, "tracing": tracing}

    # 1. card facts
    facts = card_facts(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False  # fused and plain: same algos
    print(f"[1] device {facts['name']} x{facts['count']}; nvidia-smi: "
          f"{facts['smi']}; torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}); python {sys.version.split()[0]}")

    # 2. build every kernel library, one nvcc per source, all at once
    t0 = time.perf_counter()
    libs = ("decode_attention", "flash_attention", "fused_bn",
            "int8_matmul")
    _build.build_all(libs)
    for lib in libs:
        _build.load_library(lib)
    print(f"[2] built {', '.join(libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        info = _build.build_info[lib]
        print(f"  {lib} (nvcc {info['seconds']:.1f} s):")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print("    " + line.strip())
    sm90_build = sm90_build_report(_build, facts)
    decode_build = decode_build_report(_build, facts)
    bn_build = bn_build_report(_build, facts)
    k5_build = int8_build_report(_build, facts)

    phase(3, "decode kernels against their plain versions")
    worst = check_kernels(torch, attn)
    timing = {}
    for name, quant in (("K6", False), ("K7", True)):
        timing[name] = time_kernel(torch, F, attn, quant=quant,
                                   qdtype=torch.bfloat16, facts=facts)
        print(f"  {name} timing (bf16, B=8 H=8 D=128 S=2048): "
              + json.dumps(timing[name]))
        print_decode_ratio(name, timing[name], facts)
    phase(4, "slice exactness, LM-base f32")
    exactness(torch, port)
    phase(5, "serving run, LM-base bf16")
    load16 = phase5_load(port["cfg"], 16, (64, 256))
    load8 = phase5_load(port["cfg"], 8, (32, 64))
    serve_res = {
        "K6": serving_run(torch, port, label="bf16 cache (K6)",
                          prompts=load16[0], max_new=load16[1]),
        "K7": serving_run(torch, port, label="int8 cache (K7)",
                          prompts=load8[0], max_new=load8[1],
                          kv_dtype="int8")}
    phase(6, "flash kernels (K2, K3, K4) against their plain versions")
    flash_worst = check_flash(torch, attn)
    flash_timing = time_flash(torch, F, attn, facts)
    for name, t in flash_timing.items():
        print(f"  {name} timing (bf16, B=8 H=8 S=1024 D=128 causal): "
              + json.dumps(t))
    print_flash_ratios(flash_timing, facts)
    phase(7, "LM-base-width f32 train step, flash vs reference attention")
    train_step_check(torch, port)
    phase(8, "LM-base bf16 training through lm_cli")
    train_res = training_run(torch, port)
    phase(9, "paged decode kernels (K8, K9) against their plain versions")
    paged_worst = check_paged_kernels(torch, attn)
    paged_timing = {}
    for name, quant in (("K8", False), ("K9", True)):
        paged_timing[name] = time_paged_kernel(torch, F, attn, quant=quant,
                                               facts=facts)
        print(f"  {name} timing (bf16 q, B=8 H=8 D=128, 4 pages of 512): "
              + json.dumps(paged_timing[name]))
        print_decode_ratio(name, paged_timing[name], facts)
    phase(10, "paged exactness, LM-base f32")
    paged_exactness(torch, port)
    phase(11, "paged serving, LM-base bf16")
    paged_res = paged_serving(torch, port, serve_res["K6"]["tokens"])
    phase(12, "fused BN+ReLU backward kernels (K1a, K1b) against their "
              "plain version")
    bn_worst = check_bn_kernels(torch, fused_bn, nn, vgg)
    bn_timing = time_bn_kernels(torch, fused_bn, nn, vgg, facts)
    phase(13, "VGG-11 train step, fused BN backward vs plain")
    fused_res = vgg_fused_check(torch, port)
    phase(14, "VGG-11 one epoch through cli, synthetic CIFAR-10")
    cli_res = {dt: vgg_cli_run(torch, port, extra, f"VGG-11 {dt} cli epoch "
                                                   f"({strategy or 'ddp'})",
                               strategy=strategy)
               for dt, extra, strategy in (
                   ("float32", [], "none"),
                   ("bfloat16", ["--compute-dtype", "bfloat16"], None))}
    pinit.shutdown()
    phase(15, "int8 matmul kernel (K5) against its plain version")
    k5_worst = check_int8_kernel(torch, qz)
    k5_timing = time_int8(torch, qz, facts)
    phase(16, "LM-base bf16 int8 training through lm_cli --matmul-dtype "
              "int8")
    int8_res = training_run(torch, port, extra=("--matmul-dtype", "int8"),
                            label="LM-base bf16 int8 training")
    int8_bf16_windows(torch, port, pairs=2)
    int8_step_check(torch, port)
    phase(17, "remat and the chunked head at LM-base width")
    remat_runs(torch, port)
    remat_windows(torch, port, pairs=2)
    chunked_head_check(torch, port)
    phase(18, "serving scheduling at LM-base width")
    scheduling_exactness(torch, port)
    scheduling_serving(torch, port, serve_res["K6"])
    phase(19, "data-parallel VGG-11 at world size 1 (NCCL), every strategy")
    dp_res = dp_phase(torch, port, facts)
    phase(20, "MoE (LM-base, 8 experts) and LM data parallel at world "
              "size 1")
    moe_res = moe_phase(torch, port, facts)
    phase(21, "per-step sync knobs at world size 1 (NCCL): overlap, "
              "dcn_compress, the LM codecs")
    sync_knobs_phase(torch, port, facts)
    phase(22, "sync windows at world size 1 (NCCL): VGG-11 local SGD, the "
              "outer optimizer, the LM window arithmetic")
    windows_phase(torch, port, facts)
    phase(23, "observability at LM-base width: telemetry, the profiler, "
              "train_steps, memory and SLO lanes")
    obs_res = observability_phase(torch, port, facts,
                                  train_res["device_ops_step"])
    phase(24, "checkpoints and faults at LM-base width: crash, restart and "
              "resume through launch.py, the sentry, corruption, no-plan "
              "cost")
    ckpt_res = checkpoint_phase(torch, port, facts, train_res)
    print(f"  phases done at {time.perf_counter() - T_START:.0f} s")

    kernels = []
    src = "distributed_pytorch_tpu_torch/csrc/decode_attention.cu"
    for name, line in (("K6", 507), ("K7", 515)):
        t = timing[name]
        kernels.append({
            "name": f"decode_attention ({name})", "route": "cuda",
            "source": src,
            "replaces": f"distributed_pytorch_tpu/ops/attention.py:{line}",
            "launches": serve_res[name]["launches"],
            **({"launches_moe_path": moe_res["c"]["dense"]["launches"]}
               if name == "K6" else {}),
            "max_abs_err": max(worst["max_abs_err"][name], t["max_abs_err"]),
            "err_over_tol": max(worst["err_over_tol"][name],
                                t["err_over_tol"]),
            "tolerance": {"float32": TOL_ABS["float32"],
                          "bfloat16": f"min({TOL_ABS['bfloat16']}, "
                                      f"{TOL_ROW_RMS['bfloat16']} x row RMS)"},
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **decode_extras(t, decode_build, paged=False)})
    for name, line, load in (("K8", 684, "a"), ("K9", 696, "d")):
        t = paged_timing[name]
        kernels.append({
            "name": f"decode_attention_paged ({name})", "route": "cuda",
            "source": src,
            "replaces": f"distributed_pytorch_tpu/ops/attention.py:{line}",
            "launches": paged_res[load]["launches"],
            **({"launches_moe_path": moe_res["c"]["paged"]["launches"]}
               if name == "K8" else {}),
            "max_abs_err": max(paged_worst["max_abs_err"][name],
                               t["max_abs_err"]),
            "err_over_tol": max(paged_worst["err_over_tol"][name],
                                t["err_over_tol"]),
            "tolerance": {"float32": TOL_ABS["float32"],
                          "bfloat16": f"min({TOL_ABS['bfloat16']}, "
                                      f"{TOL_ROW_RMS['bfloat16']} x row RMS)"},
            "bitwise_equal_to": "K7" if name == "K9" else "K6",
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **decode_extras(t, decode_build, paged=True)})
    src = "distributed_pytorch_tpu_torch/csrc/flash_attention.cu"
    for name, fn, line in (("K2", "flash_fwd", 97), ("K3", "flash_bwd_dq", 206),
                           ("K4", "flash_bwd_dkv", 252)):
        t = flash_timing[name]
        kernels.append({
            "name": f"{fn} ({name})", "route": "cuda", "source": src,
            "replaces": f"distributed_pytorch_tpu/ops/attention.py:{line}",
            "launches": train_res["launches"][name],
            "launches_moe_path": moe_res["b"]["launches"][name],
            "launches_observability_path": obs_res["a"]["launches"][name],
            "launches_in_profiler_trace": obs_res["a"]["trace_kernels"][
                name],
            "launches_checkpoint_path": ckpt_res["a"]["launches"][name],
            "max_abs_err": flash_worst[name]["max_abs_err"],
            "err_over_tol": flash_worst[name]["err_over_tol"],
            "tolerance": FLASH_TOL,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "tflops_per_s": t["tflops_per_s"],
            "bound_share": t["bound_share"],
            "bf16_kernel": f"{SM90_KERNELS[name]} (wgmma, TMA rings, "
                           f"persistent, warp-specialized)",
            "build": [{k: r.get(k) for k in (
                "template_int", "registers", "spill_stores", "spill_loads",
                "static_smem_bytes", "dynamic_smem_bytes")}
                for r in sm90_build[name]],
            "share_of_bf16_step_device_time": train_res[
                "flash_share_of_device_time"][name]})
        if name == "K2":
            kernels[-1]["over_library_windows"] = t["over_library"]
        else:
            kernels[-1]["k3_plus_k4_over_library"] = flash_timing[
                "K3+K4"]["over_library"]
            kernels[-1]["backward_over_library"] = flash_timing[
                "full"]["over_library"]
    src = "distributed_pytorch_tpu_torch/csrc/fused_bn.cu"
    for name, fn, line in (("K1a", "bn_relu_bwd_reduce", 106),
                           ("K1b", "bn_relu_bwd_apply", 121)):
        b16, f32 = bn_timing["bfloat16"], bn_timing["float32"]
        kernels.append({
            "name": f"{fn} ({name})", "route": "cuda", "source": src,
            "replaces": f"distributed_pytorch_tpu/ops/fused_bn.py:{line}",
            "launches": fused_res["bf16"]["launches"][name],
            "launches_dp_path": dp_res["fused_ddp"]["launches"][name],
            "max_abs_err": bn_worst[name]["max_abs_err"],
            "err_over_tol": bn_worst[name]["err_over_tol"],
            "tolerance": ("s1, s2: 1e-5 x max|s|" if name == "K1a" else
                          "da: f32 1e-5 x max|da|; bf16 one bf16 ulp + "
                          "that"),
            "shapes": "the 8 BN layers of VGG-11 at batch 256, bf16, "
                      "summed; f32 and the largest layer beside",
            "ms": b16["sum_8_layers"][name],
            "plain_ms": b16["sum_8_layers"]["plain"],
            "plain": "bn_relu_bwd_plain, K1a and K1b's work together",
            "bound_ms": b16["sum_8_layers"][f"bound_{name}"],
            "bound_by": "bytes",
            "library_ms": b16["sum_8_layers"]["library"],
            "library": "aten native_batch_norm_backward on the masked dy, "
                       "both kernels' work, no ReLU mask",
            "ms_f32": f32["sum_8_layers"][name],
            "bound_ms_f32": f32["sum_8_layers"][f"bound_{name}"],
            "ms_largest_layer_bf16": b16["largest_layer"][name],
            "bound_ms_largest_layer_bf16":
                b16["largest_layer"][f"bound_{name}"],
            "k1a_plus_k1b_as_step_runs_them": {
                dt: None if t["step_8_layers"] is None else {
                    k: t["step_8_layers"][k] for k in (
                        "ms", "library_ms", "over_library", "producer_ms")}
                for dt, t in (("bf16", b16), ("f32", f32))},
            "build": [{k: r.get(k) for k in (
                "dtype", "vec", "registers", "spill_stores", "spill_loads",
                "static_smem_bytes", "blocks_per_sm")}
                for r in bn_build if r["kernel"] == name]})
    k5 = k5_timing["per_layer"]
    kernels.append({
        "name": "int8_matmul (K5)", "route": "cuda",
        "source": "distributed_pytorch_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "distributed_pytorch_tpu/ops/quantized.py:91",
        "launches": int8_res["launches"]["K5"],
        "k5_routes": {"main_path": int8_res["k5_route_launches"],
                      "phase_15_cases": k5_worst["routes"]},
        "max_abs_err": k5_worst["max_abs_err"],
        "tolerance": "bitwise (max_abs_err must be 0), f32 and bf16 out",
        "shapes": "one LM-base layer at B=8 x S=1024: 4 x (8192, 1024) @ "
                  "(1024, 1024), 2 x @ (1024, 4096), 1 x (8192, 4096) @ "
                  "(4096, 1024), summed; bf16 output as the main path "
                  "writes it (f32 beside); per shape in per_shape",
        "ms": k5["bf16"]["ms"], "plain_ms": k5["plain_ms"],
        "plain": "the float64 integer product + epilogue on the quantized "
                 "operands",
        "bound_ms": k5["bf16"]["bound_ms"],
        "bound_by": k5["bf16"]["bound_by"],
        "library_ms": k5["bf16"]["library_ms"],
        "library": "torch._int_mm (cuBLASLt) + the same epilogue + the "
                   "bf16 cast",
        "int_mm_alone_ms": k5["int_mm_ms"],
        "mma_sync_route_ms": k5["bf16"]["mma_sync_ms"],
        "ms_f32": k5["f32"]["ms"], "bound_ms_f32": k5["f32"]["bound_ms"],
        "bound_by_f32": k5["f32"]["bound_by"],
        "mma_sync_route_ms_f32": k5["f32"]["mma_sync_ms"],
        "library_ms_f32": k5["f32"]["library_ms"],
        "sm90_kernel": "int8_matmul_sm90_kernel (wgmma s8, TMA ring, "
                       "persistent, warp-specialized)",
        "build": [{k: r.get(k) for k in (
            "out", "registers", "spill_stores", "spill_loads",
            "static_smem_bytes", "dynamic_smem_bytes")} for r in k5_build],
        "per_shape": k5_timing["shapes"]})
    if not all(k["launches"] for k in kernels):
        fail("a kernel of the main path was never launched")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {facts['smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": facts["name"], "count": facts["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
