"""CLI for transformer-LM training: the port of the JAX package's
lm_cli.py, with its parser and flag names plus ``--device``:

  python -m distributed_pytorch_tpu_torch.lm_cli --preset LM-base \\
      --steps 30 --batch-size 8 --seq-len 1024 [--n-experts 8]

It runs the training loop: the byte-level corpus (synthetic unless
``--corpus``), ``--eval-every`` on a 10% hold-out, ``--log-every`` loss and
tok/s lines, and ``--generate`` through the port's ``generate``.  It runs
on the GPU unless given ``--device cpu``.  ``--matmul-dtype int8`` (the int8
matmul, kernel K5), ``--remat full|selective``, ``--loss-impl chunked
[--loss-chunk N]`` and the MoE flags (``--n-experts``, ``--moe-top-k``,
``--moe-router``, ``--router-z-coef``) work as in the JAX package.

Data parallel, one process a device (``cuda:{LOCAL_RANK}``):

  python -m distributed_pytorch_tpu_torch.launch --nproc-per-node N -- \\
      -m distributed_pytorch_tpu_torch.lm_cli --rendezvous env --dp N

or ``--master-ip/--num-nodes/--rank`` on each process.  Under ``--rendezvous
env`` or ``--num-nodes > 1`` the trainer syncs over the gang (a gang of one
included, over a one-rank group); ``--dp`` must be its world size.  Each
rank reads its stride of the corpus (``--batch-size`` is the global batch),
rank 0 alone logs and generates, and the process group is destroyed when
the run ends.  The per-step sync knobs work as in the JAX package:
``--fsdp`` (ZeRO-3 over the slice-local data axis; ``--fsdp-gather-dtype
int8|int4`` quantizes its gathers), ``--dcn-size S`` (the two-level sync
over S slices; ``--dcn-compress int8|int4`` quantizes the cross-slice
hop with an error-feedback residual), ``--bucket-mb`` and ``--overlap``.
The sync windows too: ``--sync-every H`` (local steps, the slices
exchanging their accumulated update every H steps), ``--staleness S``
(the exchange applied S steps after it launches), ``--outer-opt
nesterov|momentum`` with ``--outer-momentum`` and ``--outer-lr`` (the
outer optimizer at each boundary), ``--sync-every-per-slice H0,H1,...``
(a window a slice) and ``--max-sync-every`` (default ``max(H, 1)``),
with the JAX CLI's checks as usage errors; a window needs ``--dcn-size``
of 2 or more.  Each needs a gang of two or more processes (``--dp``; on
GPUs, one card a process).  ``--telemetry-dir D`` (default: the launcher's
``TELEMETRY_DIR``) streams each step's span and loss / grad-norm /
param-norm gauges into D (read it with ``scripts/torch_telemetry_summary.py
D``), and ``--profile-dir P`` writes a ``torch.profiler`` Chrome trace of
steps 2-11 into P.

``--checkpoint-dir C`` resumes from the newest checkpoint in C (either
format; a corrupt one is quarantined and the one before it taken), the
data loader at the recorded (epoch, offset), and saves every
``--checkpoint-every`` steps and at the end (when a step ran): one
whole-tree npz written on a background thread, or with
``--checkpoint-sharded`` each rank's own pieces (utils/checkpoint.py).
Under ``launch.py --max-restarts N`` a worker killed by a ``FAULT_PLAN``
crash (utils/faults.py) is restarted and resumes there.  Flags of later
slices (the other parallel degrees, elastic membership) end the run with a
usage error naming the slice.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

from .data import lm_corpus
from .lm import (ELASTIC_SLICE, PARALLEL_SLICE, PLANNING_SLICE,
                 LMTrainConfig, LMTrainer, make_lm_mesh)
from .models import transformer as tfm
from .parallel import init as dist_init
from .parallel import strategies as strat
from .utils import telemetry, tracing
from .utils.logging import get_logger, setup_logging

DEFAULT_PORT = dist_init.DEFAULT_PORT  # the JAX package's rendezvous port


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_pytorch_tpu_torch.lm_cli",
        description="transformer LM trainer, one rank a GPU (PyTorch "
                    "port)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda, "
                        "cuda:{LOCAL_RANK}; 'cpu' only when asked)")
    # rendezvous (the same contract as cli.py)
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
    # parallelism (--dp: the gang's world size) and sync (later slices,
    # refused unless left at default)
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
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of steps "
                        "2-11 into this directory")
    p.add_argument("--telemetry-dir", default=None,
                   help="stream rank-tagged JSONL events (step spans, "
                        "loss/grad-norm/param-norm gauges) into this run "
                        "directory; defaults from the launcher-exported "
                        "TELEMETRY_DIR; off (and free) when neither is "
                        "set.  Read it with "
                        "scripts/torch_telemetry_summary.py")
    p.add_argument("--log-level", default="INFO")
    return p


# (flag, argparse dest, the value that leaves it off, its slice)
_LATER_FLAGS = [
    *[(f"--{n}", n, 1, PARALLEL_SLICE)
      for n in ("sp", "tp", "pp", "ep", "interleave")],
    ("--min-nodes", "min-nodes", 1, ELASTIC_SLICE),
    *[(f"--{n}", n, None, PLANNING_SLICE)
      for n in ("sync-plan", "sync-route", "autotune-profile")],
    ("--max-nodes", "max-nodes", None, ELASTIC_SLICE),
    ("--elastic", "elastic", False, ELASTIC_SLICE),
    *[(f"--{n}", n, 0, PARALLEL_SLICE) for n in ("pp-size", "microbatches")],
]


def refuse_later_flags(parser: argparse.ArgumentParser, args) -> None:
    """``parser.error`` for any flag of a later slice."""
    for flag, dest, off, where in _LATER_FLAGS:
        value = getattr(args, dest.replace("-", "_"))
        if value != off:
            parser.error(f"{flag} {value!r} is not ported to PyTorch yet: "
                         f"{where}")


def window_args(parser: argparse.ArgumentParser, args) -> None:
    """The JAX CLI's window flags: ``args.max_sync_every`` defaulted to
    ``max(--sync-every, 1)``, ``args.sync_every_per_slice`` parsed to a
    tuple, and ``require_sync_window``'s refusals as usage errors."""
    if args.max_sync_every is None:
        args.max_sync_every = max(args.sync_every, 1)
    if args.sync_every_per_slice is not None:
        try:
            args.sync_every_per_slice = tuple(
                int(x) for x in args.sync_every_per_slice.split(","))
        except ValueError:
            parser.error("--sync-every-per-slice wants comma-separated "
                         f"ints (one H per dcn slice), got "
                         f"{args.sync_every_per_slice!r}")
    if (args.sync_every != 1 or args.staleness != 0
            or args.max_sync_every != 1 or args.outer_opt is not None
            or args.sync_every_per_slice is not None):
        try:
            strat.require_sync_window(
                sync_every=args.sync_every, staleness=args.staleness,
                max_sync_every=args.max_sync_every, mesh=True,
                overlap=args.overlap,
                pp=args.pp > 1 or args.pp_size > 0,
                grad_accum=args.grad_accum, dcn_size=args.dcn_size,
                trainer="lm", outer_opt=args.outer_opt,
                outer_momentum=args.outer_momentum,
                outer_lr=args.outer_lr,
                sync_every_per_slice=args.sync_every_per_slice)
        except ValueError as e:
            parser.error(str(e))


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
    window_args(parser, args)
    refuse_later_flags(parser, args)
    # rendezvous first: the device is bound (cuda:{LOCAL_RANK}) before any
    # CUDA tensor exists
    if args.rendezvous == "env":
        device = dist_init.init_from_env(device=args.device)
    else:
        device = dist_init.init_distributed(
            args.master_ip, args.num_nodes, args.rank, port=args.port,
            device=args.device)
    tel = telemetry.enable_from_cli(args.telemetry_dir)
    try:
        return _train(args, device, on_step, tel)
    finally:
        if tel is not None and telemetry.active() is tel:
            telemetry.disable()
        dist_init.shutdown()


def _train(args, device, on_step, tel) -> LMTrainer:
    cfg = LMTrainConfig(
        model=model_config(args), lr=args.lr, seed=args.seed,
        compute_dtype=(None if args.compute_dtype == "float32"
                       else args.compute_dtype),
        warmup_steps=args.warmup_steps, decay_steps=args.decay_steps,
        dp=args.dp, grad_accum=args.grad_accum,
        matmul_dtype=args.matmul_dtype,
        loss_impl=args.loss_impl or "dense", loss_chunk=args.loss_chunk,
        remat=args.remat or "none", fsdp=args.fsdp,
        fsdp_gather_dtype=args.fsdp_gather_dtype, dcn_size=args.dcn_size,
        dcn_compress=args.dcn_compress, bucket_mb=args.bucket_mb,
        overlap=args.overlap, sync_every=args.sync_every,
        staleness=args.staleness, max_sync_every=args.max_sync_every,
        outer_opt=args.outer_opt, outer_momentum=args.outer_momentum,
        outer_lr=args.outer_lr,
        sync_every_per_slice=args.sync_every_per_slice)
    mesh = None
    if args.rendezvous == "env" or args.num_nodes > 1 or args.dp > 1:
        mesh = make_lm_mesh(cfg, device=device)  # --dp: the gang's size
    rank, world = dist_init.process_info()
    setup_logging(args.log_level if rank == 0 else "WARNING")
    log = get_logger("lm_cli")
    if tel is not None:
        log.info("telemetry: streaming to %s", tel.run_dir)
    trainer = LMTrainer(cfg, device=device, mesh=mesh)
    log.info("model: %s | device: %s | rank %d/%d", cfg.model,
             trainer.device, rank, world)
    start = 0
    if args.checkpoint_dir:
        start = trainer.maybe_restore(args.checkpoint_dir)
        if start:
            log.info("resumed at step %d", start)
    # each rank feeds its share of the global batch
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} must divide "
                         f"across {world} processes")
    per_rank = args.batch_size // world

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
                val, per_rank, args.seq_len, num_replicas=world, rank=rank,
                shuffle=False)
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
        corpus, per_rank, args.seq_len, num_replicas=world, rank=rank,
        seed=args.seed, shuffle_mode=shuffle_mode)
    if len(loader) == 0:
        raise SystemExit(
            f"corpus yields 0 batches: {loader.per_rank} windows/process "
            f"at --seq-len {args.seq_len} cannot fill a batch of "
            f"{loader.batch_size}; use a larger --corpus or smaller "
            f"--batch-size/--seq-len")

    step = start
    t_last, s_last = time.perf_counter(), start
    steps_per_epoch = len(loader)
    # the loader position: a checkpoint records it (epoch, offset); the
    # step counter gives it for one that does not
    pos = trainer.restored_meta.get("loader") if start else None
    if pos is not None and pos.get("steps_per_epoch") != steps_per_epoch:
        log.warning(
            "checkpoint loader position was recorded at %s steps/epoch, "
            "now %d — resuming from the recorded (epoch, offset) anyway",
            pos.get("steps_per_epoch"), steps_per_epoch)
    if pos is not None:
        epoch, skip = int(pos["epoch"]), int(pos["offset"])
        if skip >= steps_per_epoch:  # recorded at an epoch boundary
            epoch, skip = epoch + 1, 0
    else:
        epoch, skip = step // steps_per_epoch, step % steps_per_epoch
    loader_pos = None
    # the trace of the run's steps 2-11 under --profile-dir, closed early
    # by a shorter run or an error
    profile = contextlib.ExitStack()
    with profile:
        while step < args.steps:
            loader.set_epoch(epoch)
            for i, (tokens, targets) in enumerate(loader):
                if i < skip:
                    continue
                if args.profile_dir and step == start + 1:
                    profile.enter_context(tracing.trace(args.profile_dir))
                loss = trainer.train_step(tokens, targets)
                step += 1
                if args.profile_dir and step == start + 11:
                    profile.close()
                loader_pos = {"epoch": epoch, "offset": i + 1,
                              "steps_per_epoch": steps_per_epoch}
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
                if (args.checkpoint_dir
                        and step % args.checkpoint_every == 0):
                    trainer.save_checkpoint(
                        args.checkpoint_dir,
                        extra_meta={"loader": loader_pos},
                        sharded=args.checkpoint_sharded)
                if val_loader is not None and step % args.eval_every == 0:
                    m = trainer.evaluate(iter(val_loader))
                    log.info("step %d | val loss %.4f | ppl %.2f (%d tokens)",
                             step, m["loss"], m["ppl"], m["tokens"])
                if step >= args.steps:
                    break
            epoch, skip = epoch + 1, 0

    if args.checkpoint_dir and step > start:
        # (none when nothing trained: rewriting the restored checkpoint
        # would erase its recorded loader position)
        trainer.save_checkpoint(args.checkpoint_dir,
                                extra_meta={"loader": loader_pos},
                                sharded=args.checkpoint_sharded)
    if args.checkpoint_dir:
        trainer.flush_checkpoints()  # the files exist when run returns

    if args.generate is not None:
        params = trainer.full_params()  # a gather: every rank takes part
    if args.generate is not None and rank == 0:
        from . import generate as gen
        prompt = lm_corpus.encode(args.generate)[None]
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
