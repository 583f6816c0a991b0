"""VGG/CIFAR-10 training CLI: the port of the JAX package's cli.py, with its
parser and flag names plus ``--device``.  One process trains one rank on
one device:

  python -m distributed_pytorch_tpu_torch.cli

trains VGG-11 for ``--epochs`` at the default ``--strategy ddp`` (CIFAR-10
from ``--data-dir`` or ``./data``, else the deterministic synthetic split)
with the reference's metric windows, and evaluates on the test split after
each epoch.  It runs on the GPU (``cuda:{LOCAL_RANK}``) unless given
``--device cpu``.  The reference's launch contracts are kept:

- ``--master-ip M --num-nodes N --rank R``: explicit TCP rendezvous on
  ``--port`` (main_all_reduce.py:86-96);
- ``--rendezvous env``: MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK, as
  ``launch.py`` and torchrun export them (main_ddp.py:93-104);
- neither: one rank, over a one-rank process group for the strategies that
  sync (``--strategy none`` is the reference's main.py).

``--num-devices N > 1`` in one process is refused: the port runs one
process per device (``python -m distributed_pytorch_tpu_torch.launch
--nproc-per-node N -- -m distributed_pytorch_tpu_torch.cli --rendezvous
env``).  ``--overlap`` syncs each gradient bucket inside the backward
and ``--dcn-compress`` quantizes hierarchical's cross-slice hop.
``--sync-every H`` trains in local-SGD windows (``--outer-opt`` for the
outer optimizer; ``--max-sync-every`` defaults to ``max(H, 1)``), with
the JAX CLI's checks: a window must end each ``train_steps`` call, which
at the trainer's ``steps_per_loop`` of 1 the trainer refuses, as the JAX
one does, and ``--sync-every-per-slice`` is the LM trainer's.
``--telemetry-dir D`` (default: the launcher's ``TELEMETRY_DIR``) streams
the run's rank-tagged events into D (utils/telemetry.py; read them with
``scripts/torch_telemetry_summary.py D``), and ``--profile-dir P`` writes a
``torch.profiler`` Chrome trace of the first epoch into P.
``--checkpoint-dir C`` restores the newest verified checkpoint in C (a
corrupt one is quarantined and the one before it taken), resumes at its
epoch, and saves after every epoch (utils/checkpoint.py ``Checkpointer``:
params, every rank's BN state, the momentum); a worker the launcher
restarts after a crash resumes there.  ``--elastic`` (with
``--checkpoint-dir`` and a strategy with a mesh) makes the run an elastic
gang's member: under ``launch.py --elastic`` it publishes a heartbeat at
each dispatch, and on SIGTERM it leaves at the next epoch boundary, every
rank at the same one, saves its checkpoint and exits
``ELASTIC_DRAIN_EXIT_CODE`` (parallel/elastic.py), so the resized gang
resumes there.  The planner's flags of slice 5f raise
``NotImplementedError`` naming it.  ``--model`` also takes ``TINY``, the package's smoke
configuration.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from . import eval as evaluation
from .data.cifar10 import load
from .data.pipeline import DataLoader
from .data.sampler import DistributedSampler
from .models.transformer import PLANNING_SLICE, not_ported
from .parallel import elastic as elastic_mod
from .parallel import init as dist_init
from .parallel import strategies as strat
from .parallel.mesh import one_process_per_device
from .train import STRATEGIES, TrainConfig, Trainer
from .utils import checkpoint, telemetry, tracing
from .utils.logging import get_logger, setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_pytorch_tpu_torch.cli",
        description="VGG/CIFAR-10 trainer, one rank a GPU (PyTorch port)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda, "
                        "cuda:{LOCAL_RANK}; 'cpu' only when asked)")
    # rendezvous (reference main_all_reduce.py:86-92, main_ddp.py:93-104)
    p.add_argument("--master-ip", type=str, default=None,
                   help="coordinator host (rank 0), reference --master-ip")
    p.add_argument("--num-nodes", type=int, default=1,
                   help="number of processes, reference --num-nodes")
    p.add_argument("--rank", type=int, default=0,
                   help="this process's rank, reference --rank")
    p.add_argument("--port", type=int, default=dist_init.DEFAULT_PORT)
    p.add_argument("--rendezvous", choices=["args", "env"], default="args",
                   help="'args' = explicit --master-ip/--rank "
                        "(main_all_reduce.py:96); 'env' = torchrun-style "
                        "MASTER_ADDR/RANK env vars (main_ddp.py:93-104)")
    p.add_argument("--rendezvous-timeout", type=int,
                   default=dist_init.DEFAULT_TIMEOUT_S,
                   help="seconds before rendezvous fails loudly")
    # gradient sync
    p.add_argument("--strategy", default="ddp", choices=list(STRATEGIES),
                   help="gradient-sync strategy (parallel/strategies.py); "
                        "'auto' and 'routed' belong to slice 5f")
    p.add_argument("--sync-route", default=None)
    p.add_argument("--autotune-profile", default=None)
    p.add_argument("--dcn-size", type=int, default=2,
                   help="number of slices for --strategy hierarchical: the "
                        "ranks factor into a ('dcn', 'ici') mesh")
    p.add_argument("--dcn-compress", default=None, choices=["int8", "int4"],
                   help="quantize hierarchical's cross-slice hop (an int8 "
                        "or int4 ring with an error-feedback residual)")
    p.add_argument("--overlap", action="store_true",
                   help="sync each gradient bucket inside the backward, "
                        "at its earliest layer group")
    p.add_argument("--overlap-bucket-mb", type=float, default=None,
                   help="bucket size of --overlap, bucketed and the rings "
                        "(default: torch DDP's 25 MB)")
    p.add_argument("--sync-every", type=int, default=1)
    p.add_argument("--max-sync-every", type=int, default=None)
    p.add_argument("--outer-opt", default=None,
                   choices=["nesterov", "momentum"])
    p.add_argument("--outer-momentum", type=float, default=0.9)
    p.add_argument("--outer-lr", type=float, default=1.0)
    p.add_argument("--sync-every-per-slice", default=None)
    # training hyper-parameters; defaults are the reference's exact values
    p.add_argument("--model", default="VGG11",
                   choices=["VGG11", "VGG13", "VGG16", "VGG19", "TINY"])
    p.add_argument("--epochs", type=int, default=1)     # main.py:106
    p.add_argument("--batch-size", type=int, default=256)  # main.py:18
    p.add_argument("--lr", type=float, default=0.1)     # main.py:103
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=1)       # main.py:70
    p.add_argument("--compute-dtype", default=None,
                   choices=[None, "bfloat16", "float32"],
                   help="bfloat16 compute over float32 params")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--sync-bn", action="store_true",
                   help="cross-rank BatchNorm (the reference never syncs "
                        "BN; default off for parity)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--num-devices", type=int, default=None,
                   help="devices of this process: one (launch.py "
                        "--nproc-per-node N runs N processes)")
    # capabilities of the JAX package beyond the reference
    p.add_argument("--checkpoint-dir", default=None,
                   help="restore the newest checkpoint here, then save "
                        "one after every epoch")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the first "
                        "epoch into this directory")
    p.add_argument("--telemetry-dir", default=None,
                   help="stream rank-tagged JSONL events (step spans, "
                        "loss/grad-norm/param-norm gauges) into this run "
                        "directory; defaults from the launcher-exported "
                        "TELEMETRY_DIR; off (and free) when neither is "
                        "set.  Read it with "
                        "scripts/torch_telemetry_summary.py")
    p.add_argument("--shard-eval", action="store_true",
                   help="shard the test set over the ranks (all-reduced "
                        "sums) instead of the reference's redundant "
                        "per-rank evaluation")
    p.add_argument("--fold-bn-eval", action="store_true",
                   help="fold BatchNorm statistics into the conv weights "
                        "for evaluation")
    p.add_argument("--elastic", action="store_true",
                   help="run as an elastic gang's member (launch.py "
                        "--elastic): publish heartbeats at dispatch "
                        "cadence and honour the agent's drain at epoch "
                        "boundaries: save a checkpoint and exit with the "
                        "drain code so the resized gang resumes "
                        "resharded (requires --checkpoint-dir; the LM "
                        "CLI drains at step granularity)")
    p.add_argument("--min-nodes", type=int, default=1,
                   help="elastic: smallest world size this config can "
                        "train at (the agent enforces the bound)")
    p.add_argument("--max-nodes", type=int, default=None,
                   help="elastic: largest world size (default: the "
                        "launch world size)")
    p.add_argument("--debug-checks", action="store_true",
                   help="after each epoch, verify the data-parallel "
                        "invariants: params and momentum bitwise equal on "
                        "every rank, and finite (utils/debug.py)")
    p.add_argument("--log-level", default="INFO")
    return p


# (flag, the value that leaves it off, its sub-slice)
_LATER_FLAGS = [
    *[(f"--{n}", None, PLANNING_SLICE) for n in ("sync-route",
                                                 "autotune-profile")],
]


def refuse_later_flags(args) -> None:
    """NotImplementedError, naming its sub-slice, for any flag of a later
    slice; and for ``--num-devices`` other than one process's one device."""
    for flag, off, where in _LATER_FLAGS:
        value = getattr(args, flag[2:].replace("-", "_"))
        if value != off:
            raise not_ported(f"{flag} {value!r}", where)
    if args.num_devices not in (None, 1):
        one_process_per_device(args.num_devices)


def elastic_args(parser: argparse.ArgumentParser, args) -> None:
    """The JAX CLI's ``--elastic`` checks, as usage errors: it needs
    ``--checkpoint-dir`` and a strategy with a mesh, and the bounds need
    it."""
    if args.elastic:
        if not args.checkpoint_dir:
            parser.error(
                "--elastic requires --checkpoint-dir: the drain sync "
                "point must flush a checkpoint for the resized gang to "
                "resume from")
        if args.strategy == "none":
            parser.error(
                "--elastic needs a mesh-backed strategy (there is no "
                "topology to resize under --strategy none)")
        if args.min_nodes < 1 or (args.max_nodes is not None
                                  and args.max_nodes < args.min_nodes):
            parser.error("--min-nodes/--max-nodes must satisfy "
                         "1 <= min <= max")
    elif args.min_nodes != 1 or args.max_nodes is not None:
        parser.error("--min-nodes/--max-nodes configure --elastic; pass "
                     "it (or drop the bounds)")


def window_args(parser: argparse.ArgumentParser, args) -> int:
    """The JAX CLI's window flags: ``--max-sync-every`` (default ``max(
    --sync-every, 1)``, returned), ``--sync-every-per-slice`` parsed, and
    ``require_sync_window``'s refusals as usage errors."""
    max_sync_every = (args.max_sync_every if args.max_sync_every is not None
                      else max(args.sync_every, 1))
    sync_every_per_slice = None
    if args.sync_every_per_slice is not None:
        try:
            sync_every_per_slice = tuple(
                int(x) for x in args.sync_every_per_slice.split(","))
        except ValueError:
            parser.error(
                f"--sync-every-per-slice must be a comma-separated list of "
                f"ints, got {args.sync_every_per_slice!r}")
    if (args.sync_every != 1 or max_sync_every != 1
            or args.outer_opt is not None
            or sync_every_per_slice is not None):
        meshless = (args.strategy not in ("auto", "routed")
                    and not strat.get(args.strategy).needs_mesh)
        try:
            strat.require_sync_window(
                sync_every=args.sync_every, max_sync_every=max_sync_every,
                mesh=not meshless, overlap=args.overlap, trainer="train",
                outer_opt=args.outer_opt,
                outer_momentum=args.outer_momentum,
                outer_lr=args.outer_lr,
                sync_every_per_slice=sync_every_per_slice)
        except ValueError as e:
            parser.error(str(e))
    return max_sync_every


def build_loaders(args, n_replicas: int, replica_offset: int
                  ) -> tuple[list[DataLoader], DataLoader]:
    """This rank's train loader and one test loader over the full test
    split.  One replica: shuffled (the single-process baseline's, reference
    main.py:85-90); several: a ``DistributedSampler(num_replicas, rank)``
    shard (main_all_reduce.py:112).  The test set is not sharded (every
    rank evaluates all of it, main_gather.py:131) unless ``--shard-eval``,
    which reads ``test_loader.dataset``."""
    train_set = load("train", args.data_dir)
    test_set = load("test", args.data_dir)
    if n_replicas == 1:
        train = DataLoader(train_set, args.batch_size, shuffle=True, seed=0)
    else:
        train = DataLoader(train_set, args.batch_size,
                           sampler=DistributedSampler(
                               len(train_set), num_replicas=n_replicas,
                               rank=replica_offset, shuffle=True, seed=0))
    return [train], DataLoader(test_set, args.batch_size)


def run(argv: list[str] | None = None, on_step=None) -> dict:
    """Parse ``argv``, rendezvous, train ``--epochs`` epochs and evaluate
    after each, then destroy the process group; returns ``{"trainer",
    "epochs": [{"loss_meter", "time_meter", "eval": (avg_loss,
    accuracy)}], "synthetic", "start_epoch"}`` (the epochs run, from the
    restored one).  ``on_step(step)`` is passed to
    ``Trainer.train_epoch``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    elastic_args(parser, args)
    refuse_later_flags(args)
    args.max_sync_every = window_args(parser, args)
    # rendezvous first: the device is bound (cuda:{LOCAL_RANK}) before any
    # CUDA tensor exists, as the reference's init precedes every torch call
    if args.rendezvous == "env":
        device = dist_init.init_from_env(timeout_s=args.rendezvous_timeout,
                                         device=args.device)
    else:
        device = dist_init.init_distributed(
            args.master_ip, args.num_nodes, args.rank, port=args.port,
            timeout_s=args.rendezvous_timeout, device=args.device)
    setup_logging(args.log_level)
    tel = telemetry.enable_from_cli(args.telemetry_dir)
    try:
        return _train(args, device, on_step, tel)
    finally:
        if tel is not None and telemetry.active() is tel:
            telemetry.disable()
        dist_init.shutdown()


def _train(args, device, on_step, tel) -> dict:
    log = get_logger("cli")
    if tel is not None:
        log.info("telemetry: streaming to %s", tel.run_dir)
    cfg = TrainConfig(
        model=args.model, lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay, batch_size=args.batch_size,
        strategy=args.strategy, sync_bn=args.sync_bn,
        compute_dtype=args.compute_dtype, augment=not args.no_augment,
        seed=args.seed, dcn_size=args.dcn_size,
        dcn_compress=args.dcn_compress, overlap=args.overlap,
        overlap_bucket_mb=args.overlap_bucket_mb,
        sync_every=args.sync_every, max_sync_every=args.max_sync_every,
        outer_opt=args.outer_opt, outer_momentum=args.outer_momentum,
        outer_lr=args.outer_lr)
    try:
        trainer = Trainer(cfg, num_devices=args.num_devices, device=device)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    rank, world = dist_init.process_info()
    if args.shard_eval and trainer.mesh is not None and \
            args.batch_size % trainer.n_replicas:
        raise SystemExit(
            f"--shard-eval: --batch-size {args.batch_size} must divide "
            f"across {trainer.n_replicas} ranks (fail fast, before a whole "
            f"epoch is spent)")
    log.info("device=%s rank=%d/%d strategy=%s model=%s", trainer.device,
             rank, world, args.strategy, args.model)
    train_loaders, test_loader = build_loaders(args, trainer.n_replicas,
                                               trainer.rank)
    synthetic = train_loaders[0].dataset.synthetic
    log.info("CIFAR-10: %d train / %d test images (%s)",
             len(train_loaders[0].dataset), len(test_loader.dataset),
             "synthetic" if synthetic else "on disk")
    start_epoch, ckpt = 0, None
    if args.checkpoint_dir:
        ckpt = checkpoint.Checkpointer(args.checkpoint_dir)
        start_epoch = ckpt.maybe_restore(trainer)
        if start_epoch:
            log.info("resumed from checkpoint at epoch %d", start_epoch)
    heartbeat = drain_guard = None
    if args.elastic:
        # a drain on SIGTERM (at epoch boundaries: train_epoch is one
        # dispatch pipeline; the LM CLI drains a step at a time), and
        # heartbeats when an elastic agent launched us
        drain_guard = elastic_mod.DrainGuard().install()
        ectx = elastic_mod.ElasticContext.from_env()
        if ectx is not None:
            heartbeat = elastic_mod.Heartbeat(ectx.run_dir, ectx.rank,
                                              ectx.generation)

    def step_hook(step):
        # a heartbeat at dispatch cadence: an epoch longer than the
        # agent's staleness bound must not read as a hang
        if heartbeat is not None:
            heartbeat.beat(step)
        if on_step is not None:
            on_step(step)

    epochs = []
    for epoch in range(start_epoch, args.epochs):
        if drain_guard is not None and drain_guard.sync():
            log.info("drain requested: flushing checkpoint at epoch %d "
                     "and leaving at the sync point", epoch)
            elastic_mod.drain_exit(lambda: ckpt.save(trainer, epoch))
        with (tracing.trace(args.profile_dir)
              if args.profile_dir and epoch == start_epoch
              else contextlib.nullcontext()):
            loss_meter, time_meter = trainer.train_epoch(
                train_loaders, epoch,
                on_step=(step_hook if heartbeat is not None
                         or on_step is not None else None))
        if args.debug_checks:
            trainer.check_consistency()
            log.info("epoch %d: replica-consistency checks passed",
                     epoch + 1)
        if args.shard_eval and trainer.mesh is None:
            log.warning("--shard-eval ignored: strategy %s runs without a "
                        "mesh", args.strategy)
        if args.shard_eval and trainer.mesh is not None:
            result = evaluation.evaluate_sharded(
                trainer.params, trainer.eval_state(), test_loader.dataset,
                trainer.mesh, batch_size=args.batch_size,
                model_name=args.model, compute_dtype=cfg.dtype,
                fold_bn=args.fold_bn_eval, device=trainer.device)
        else:
            result = evaluation.evaluate(
                trainer.params, trainer.eval_state(), test_loader,
                model_name=args.model, compute_dtype=cfg.dtype,
                fold_bn=args.fold_bn_eval, device=trainer.device)
        epochs.append({"loss_meter": loss_meter, "time_meter": time_meter,
                       "eval": result})
        if ckpt is not None:
            ckpt.save(trainer, epoch + 1)
    return {"trainer": trainer, "epochs": epochs, "synthetic": synthetic,
            "start_epoch": start_epoch}


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
