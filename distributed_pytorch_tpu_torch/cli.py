"""VGG/CIFAR-10 training CLI on one device: the port of the JAX package's
cli.py, with its parser and flag names plus ``--device``:

  python -m distributed_pytorch_tpu_torch.cli --strategy none

trains VGG-11 for ``--epochs`` (CIFAR-10 from ``--data-dir`` or ``./data``,
else the deterministic synthetic split) with the reference's metric
windows, and evaluates on the test split after each epoch.  It runs on the
GPU unless given ``--device cpu``.  ``--strategy none`` is the reference's
single-process main.py; every other strategy, and the rendezvous, elastic,
checkpoint, profile, telemetry, sharded-eval, debug-check and sync flags,
belong to the data-parallel slice and raise ``NotImplementedError`` naming
it.  ``--model`` also takes ``TINY``, the package's smoke configuration.
"""

from __future__ import annotations

import argparse
import logging
import sys

from . import eval as evaluation
from .data.cifar10 import load
from .data.pipeline import DataLoader
from .data.sampler import DistributedSampler
from .models.transformer import not_ported
from .train import STRATEGIES, SYSTEMS_SLICE, TrainConfig, Trainer

DEFAULT_PORT = 6585  # the JAX package's rendezvous port
DEFAULT_TIMEOUT_S = 300


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_pytorch_tpu_torch.cli",
        description="VGG/CIFAR-10 trainer on one GPU (PyTorch port)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; 'cpu' "
                        "only when asked)")
    # rendezvous (multi-process: a later slice)
    p.add_argument("--master-ip", type=str, default=None)
    p.add_argument("--num-nodes", type=int, default=1)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.add_argument("--rendezvous", choices=["args", "env"], default="args")
    p.add_argument("--rendezvous-timeout", type=int,
                   default=DEFAULT_TIMEOUT_S)
    # gradient sync (a later slice, except --strategy none)
    p.add_argument("--strategy", default="ddp", choices=list(STRATEGIES),
                   help="gradient-sync strategy; 'none' (the reference's "
                        "single-process main.py) is the one ported")
    p.add_argument("--sync-route", default=None)
    p.add_argument("--autotune-profile", default=None)
    p.add_argument("--dcn-size", type=int, default=2)
    p.add_argument("--dcn-compress", default=None, choices=["int8", "int4"])
    p.add_argument("--overlap", action="store_true")
    p.add_argument("--overlap-bucket-mb", type=float, default=None)
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
    p.add_argument("--sync-bn", action="store_true")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--num-devices", type=int, default=None)
    # capabilities of the JAX package beyond the reference (a later slice,
    # except --fold-bn-eval)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--telemetry-dir", default=None)
    p.add_argument("--shard-eval", action="store_true")
    p.add_argument("--fold-bn-eval", action="store_true",
                   help="fold BatchNorm statistics into the conv weights "
                        "for evaluation")
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--min-nodes", type=int, default=1)
    p.add_argument("--max-nodes", type=int, default=None)
    p.add_argument("--debug-checks", action="store_true")
    p.add_argument("--log-level", default="INFO")
    return p


# (flag, the value that leaves it off); all belong to the data-parallel slice
_LATER_FLAGS = [
    *[(f"--{n}", None) for n in (
        "master-ip", "sync-route", "autotune-profile", "dcn-compress",
        "overlap-bucket-mb", "max-sync-every", "outer-opt",
        "sync-every-per-slice", "checkpoint-dir", "profile-dir",
        "telemetry-dir", "max-nodes")],
    *[(f"--{n}", False) for n in ("overlap", "sync-bn", "shard-eval",
                                  "elastic", "debug-checks")],
    *[(f"--{n}", 1) for n in ("num-nodes", "sync-every", "min-nodes")],
    ("--rank", 0), ("--dcn-size", 2), ("--rendezvous", "args"),
]


def refuse_later_flags(args) -> None:
    """NotImplementedError, naming the slice, for any flag of a later
    slice."""
    for flag, off in _LATER_FLAGS:
        value = getattr(args, flag[2:].replace("-", "_"))
        if value != off:
            raise not_ported(f"{flag} {value!r}", SYSTEMS_SLICE)
    if args.num_devices not in (None, 1):
        raise not_ported(f"--num-devices {args.num_devices}", SYSTEMS_SLICE)


def build_loaders(args) -> tuple[list[DataLoader], DataLoader]:
    """One train loader (shuffled, the single-process baseline's: reference
    main.py:85-90) and one test loader over the full test split."""
    train_set = load("train", args.data_dir)
    test_set = load("test", args.data_dir)
    return ([DataLoader(train_set, args.batch_size, shuffle=True, seed=0)],
            DataLoader(test_set, args.batch_size))


def run(argv: list[str] | None = None, on_step=None) -> dict:
    """Parse ``argv``, train ``--epochs`` epochs and evaluate after each;
    returns ``{"trainer", "epochs": [{"loss_meter", "time_meter",
    "eval": (avg_loss, accuracy)}], "synthetic"}``.  ``on_step(step)`` is
    passed to ``Trainer.train_epoch``."""
    args = build_parser().parse_args(argv)
    refuse_later_flags(args)
    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log = logging.getLogger("cli")
    cfg = TrainConfig(
        model=args.model, lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay, batch_size=args.batch_size,
        strategy=args.strategy, compute_dtype=args.compute_dtype,
        augment=not args.no_augment, seed=args.seed,
        outer_momentum=args.outer_momentum, outer_lr=args.outer_lr)
    trainer = Trainer(cfg, device=args.device)
    log.info("device=%s strategy=%s model=%s", trainer.device,
             args.strategy, args.model)
    train_loaders, test_loader = build_loaders(args)
    synthetic = train_loaders[0].dataset.synthetic
    log.info("CIFAR-10: %d train / %d test images (%s)",
             len(train_loaders[0].dataset), len(test_loader.dataset),
             "synthetic" if synthetic else "on disk")
    epochs = []
    for epoch in range(args.epochs):
        loss_meter, time_meter = trainer.train_epoch(
            train_loaders, epoch, on_step=on_step)
        result = evaluation.evaluate(
            trainer.params, trainer.eval_state(), test_loader,
            model_name=args.model, compute_dtype=cfg.dtype,
            fold_bn=args.fold_bn_eval, device=trainer.device)
        epochs.append({"loss_meter": loss_meter, "time_meter": time_meter,
                       "eval": result})
    return {"trainer": trainer, "epochs": epochs, "synthetic": synthetic}


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
