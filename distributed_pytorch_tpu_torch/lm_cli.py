"""CLI for transformer-LM training on one device: the port of the JAX
package's lm_cli.py, with its parser and flag names plus ``--device``:

  python -m distributed_pytorch_tpu_torch.lm_cli --preset LM-base \\
      --steps 30 --batch-size 8 --seq-len 1024

It runs the single-device loop: the byte-level corpus (synthetic unless
``--corpus``), ``--eval-every`` on a 10% hold-out, ``--log-every`` loss and
tok/s lines, and ``--generate`` through the port's ``generate``.  It runs
on the GPU unless given ``--device cpu``.  ``--matmul-dtype int8`` (the int8
matmul, kernel K5), ``--remat full|selective`` and ``--loss-impl chunked
[--loss-chunk N]`` work as in the JAX package.  Flags of later slices
(parallel degrees, elastic membership, checkpoints, telemetry, profiling,
the sync knobs, MoE) end the run with a usage error naming the slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time

import numpy as np
import torch

from .data import lm_corpus
from .lm import SYSTEMS_SLICE, LMTrainConfig, LMTrainer
from .models import transformer as tfm

DEFAULT_PORT = 6585  # the JAX package's rendezvous port


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_pytorch_tpu_torch.lm_cli",
        description="transformer LM trainer on one GPU (PyTorch port)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; 'cpu' "
                        "only when asked)")
    # rendezvous (multi-process: a later slice)
    p.add_argument("--master-ip", default=None)
    p.add_argument("--num-nodes", type=int, default=1)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.add_argument("--rendezvous", choices=["args", "env"], default="args")
    # model
    p.add_argument("--preset", default="LM-tiny",
                   choices=sorted(tfm.PRESETS))
    p.add_argument("--d-model", type=int, default=None)
    p.add_argument("--n-layers", type=int, default=None)
    p.add_argument("--n-heads", type=int, default=None)
    p.add_argument("--n-kv-heads", type=int, default=None,
                   help="grouped-query attention (default: n_heads)")
    p.add_argument("--head-dim", type=int, default=None)
    p.add_argument("--n-experts", type=int, default=None)
    p.add_argument("--moe-top-k", type=int, default=None)
    p.add_argument("--moe-router", default=None,
                   choices=["tokens", "experts"])
    p.add_argument("--router-z-coef", type=float, default=None)
    # parallelism and sync (later slices, refused unless left at default)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer "
                        "step (CE gradient exact)")
    p.add_argument("--pp-size", type=int, default=0)
    p.add_argument("--microbatches", type=int, default=0)
    p.add_argument("--interleave", type=int, default=1)
    p.add_argument("--dcn-size", type=int, default=1)
    p.add_argument("--dcn-compress", default=None, choices=["int8", "int4"])
    p.add_argument("--fsdp-gather-dtype", default=None,
                   choices=["int8", "int4"])
    p.add_argument("--matmul-dtype", default=None, choices=["int8"])
    p.add_argument("--loss-impl", default=None,
                   choices=["dense", "chunked"])
    p.add_argument("--loss-chunk", type=int, default=None)
    p.add_argument("--remat", default=None,
                   choices=["none", "full", "selective"])
    p.add_argument("--bucket-mb", type=float, default=None)
    p.add_argument("--sync-plan", default=None, choices=["auto"])
    p.add_argument("--sync-route", default=None)
    p.add_argument("--autotune-profile", default=None)
    p.add_argument("--sync-every", type=int, default=1)
    p.add_argument("--staleness", type=int, default=0)
    p.add_argument("--max-sync-every", type=int, default=None)
    p.add_argument("--outer-opt", choices=("nesterov", "momentum"),
                   default=None)
    p.add_argument("--outer-momentum", type=float, default=0.9)
    p.add_argument("--outer-lr", type=float, default=1.0)
    p.add_argument("--sync-every-per-slice", default=None)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--min-nodes", type=int, default=1)
    p.add_argument("--max-nodes", type=int, default=None)
    p.add_argument("--overlap", action="store_true")
    # training
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8,
                   help="global batch (sequences per step)")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--decay-steps", type=int, default=0,
                   help="cosine-decay horizon (0 = constant LR)")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--corpus", default=None,
                   help="path to a text file (byte-level); default: "
                        "deterministic synthetic corpus")
    p.add_argument("--mmap-corpus", action="store_true",
                   help="memory-map --corpus instead of loading it")
    p.add_argument("--shuffle-mode", default=None,
                   choices=["permutation", "affine"])
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate held-out loss/ppl every N steps (holds "
                        "out the final 10%% of the corpus)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--checkpoint-sharded", action="store_true")
    # sampling after training
    p.add_argument("--generate", default=None, metavar="PROMPT",
                   help="sample text from the trained model")
    p.add_argument("--max-new", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--kv-dtype", default=None, choices=("int8",),
                   help="KV-cache storage for sampling")
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--telemetry-dir", default=None)
    p.add_argument("--log-level", default="INFO")
    return p


# (flag, argparse dest, the value that leaves it off, its slice)
_LATER_FLAGS = [
    *[(f"--{n}", n, 1, SYSTEMS_SLICE)
      for n in ("dp", "sp", "tp", "pp", "ep", "interleave", "num-nodes",
                "dcn-size", "sync-every", "min-nodes")],
    *[(f"--{n}", n, None, SYSTEMS_SLICE)
      for n in ("master-ip", "dcn-compress", "fsdp-gather-dtype",
                "bucket-mb", "sync-plan", "sync-route", "autotune-profile",
                "max-sync-every", "outer-opt", "sync-every-per-slice",
                "max-nodes", "checkpoint-dir", "profile-dir",
                "telemetry-dir")],
    *[(f"--{n}", n, False, SYSTEMS_SLICE)
      for n in ("fsdp", "elastic", "overlap", "checkpoint-sharded")],
    *[(f"--{n}", n, 0, SYSTEMS_SLICE)
      for n in ("pp-size", "microbatches", "staleness", "rank")],
    ("--rendezvous", "rendezvous", "args", SYSTEMS_SLICE),
    ("--n-experts", "n-experts", None, tfm.MOE_SLICE),
]


def refuse_later_flags(parser: argparse.ArgumentParser, args) -> None:
    """``parser.error`` for any flag of a later slice."""
    for flag, dest, off, where in _LATER_FLAGS:
        value = getattr(args, dest.replace("-", "_"))
        if value != off:
            parser.error(f"{flag} {value!r} is not ported to PyTorch yet: "
                         f"{where}")


def model_config(args) -> tfm.TransformerConfig:
    cfg = tfm.PRESETS[args.preset]
    # byte-level corpus: the vocab is always 256
    overrides = {"vocab_size": lm_corpus.VOCAB_SIZE}
    for name in ("d_model", "n_layers", "n_heads", "n_kv_heads",
                 "head_dim", "n_experts", "moe_top_k", "moe_router",
                 "router_z_coef"):
        val = getattr(args, name)
        if val is not None:
            overrides[name] = val
    return dataclasses.replace(cfg, **overrides)


def run(argv: list[str] | None = None, on_step=None) -> LMTrainer:
    """Parse ``argv``, train, and return the trainer.  ``on_step(step,
    trainer, loss)``, when given, is called after every optimizer step
    (``loss`` is the step's 0-dim tensor, not fetched)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mmap_corpus and not args.corpus:
        parser.error("--mmap-corpus requires --corpus (the synthetic "
                     "fallback is generated in RAM)")
    if args.loss_chunk is not None and args.loss_impl != "chunked":
        parser.error("--loss-chunk tunes the chunked head; pass "
                     "--loss-impl chunked (or drop the chunk size)")
    if args.remat in ("full", "selective") and (args.pp > 1
                                                or args.pp_size > 0):
        parser.error("--remat does not compose with --pp/--pp-size: the "
                     "pipeline schedulers own their own rematerialization; "
                     "drop one")
    refuse_later_flags(parser, args)
    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log = logging.getLogger("lm_cli")

    cfg = LMTrainConfig(
        model=model_config(args), lr=args.lr, seed=args.seed,
        compute_dtype=(None if args.compute_dtype == "float32"
                       else args.compute_dtype),
        warmup_steps=args.warmup_steps, decay_steps=args.decay_steps,
        grad_accum=args.grad_accum, matmul_dtype=args.matmul_dtype,
        loss_impl=args.loss_impl or "dense", loss_chunk=args.loss_chunk,
        remat=args.remat or "none")
    trainer = LMTrainer(cfg, device=args.device)
    log.info("model: %s | device: %s", cfg.model, trainer.device)

    corpus = lm_corpus.load_corpus(args.corpus, mmap=args.mmap_corpus)
    log.info("corpus: %d tokens (%s)", len(corpus),
             "synthetic" if corpus.synthetic else args.corpus)
    val_loader = None
    if args.eval_every > 0:
        # hold out the final 10% of the stream for evaluation
        split = int(len(corpus) * 0.9)
        val = lm_corpus.LMCorpus(corpus.tokens[split:], corpus.synthetic)
        try:
            candidate = lm_corpus.LMDataLoader(
                val, args.batch_size, args.seq_len, shuffle=False)
        except ValueError:
            candidate = None
        if candidate is None or len(candidate) == 0:
            log.warning(
                "corpus too small for a 10%% eval holdout at --seq-len %d / "
                "--batch-size %d; --eval-every disabled", args.seq_len,
                args.batch_size)
        else:
            val_loader = candidate
            corpus = lm_corpus.LMCorpus(corpus.tokens[:split],
                                        corpus.synthetic)
    shuffle_mode = args.shuffle_mode or (
        "affine" if args.mmap_corpus else "permutation")
    loader = lm_corpus.LMDataLoader(
        corpus, args.batch_size, args.seq_len, seed=args.seed,
        shuffle_mode=shuffle_mode)
    if len(loader) == 0:
        raise SystemExit(
            f"corpus yields 0 batches: {loader.per_rank} windows cannot "
            f"fill a batch of {loader.batch_size} at --seq-len "
            f"{args.seq_len}; use a larger --corpus or smaller "
            f"--batch-size/--seq-len")

    step, epoch = 0, 0
    t_last, s_last = time.perf_counter(), 0
    while step < args.steps:
        loader.set_epoch(epoch)
        for tokens, targets in loader:
            loss = trainer.train_step(tokens, targets)
            step += 1
            if on_step is not None:
                on_step(step, trainer, loss)
            if step % args.log_every == 0:
                loss_v = float(loss)  # waits for the device
                dt = time.perf_counter() - t_last
                tok_s = ((step - s_last) * args.batch_size * args.seq_len
                         / max(dt, 1e-9))
                log.info("step %d | loss %.4f | %.0f tok/s", step, loss_v,
                         tok_s)
                t_last, s_last = time.perf_counter(), step
            if val_loader is not None and step % args.eval_every == 0:
                m = trainer.evaluate(iter(val_loader))
                log.info("step %d | val loss %.4f | ppl %.2f (%d tokens)",
                         step, m["loss"], m["ppl"], m["tokens"])
            if step >= args.steps:
                break
        epoch += 1

    if args.generate is not None:
        from . import generate as gen
        prompt = lm_corpus.encode(args.generate)[None]
        params = {n: p.detach() for n, p in trainer.params.items()}
        with torch.no_grad():
            out = gen.generate(
                params, prompt.astype(np.int32), args.seed, cfg=cfg.model,
                max_new=args.max_new, temperature=args.temperature,
                top_k=args.top_k, top_p=args.top_p, dtype=cfg.dtype,
                kv_dtype=args.kv_dtype, device=trainer.device)
        print(lm_corpus.decode(out[0].cpu().numpy()))
    return trainer


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
