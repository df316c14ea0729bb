"""Command line of the port's trainer (the JAX package's flag names).

    python -m gtopkssgd_tpu_torch.dist_trainer --dnn resnet20 \\
        --compression gtopk --density 0.001 --topk-method twostage \\
        --num-iters 20 [--device cpu]

Runs on the CUDA card unless ``--device cpu``. Prints one JSON line with
the per-step losses and step times. One worker so far: ``--nworkers``
above 1 is refused until the gTop-k collective lands.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Optional, Sequence

from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dnn", default="resnet20")
    p.add_argument("--dataset", default=None)
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-worker batch size")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--compression", default=None,
                   help="dense (default) | gtopk")
    p.add_argument("--density", type=float, default=0.001)
    p.add_argument("--topk-method", default="auto",
                   help="auto | exact | threshold | pallas | twostage")
    p.add_argument("--nsteps-update", type=int, default=1)
    p.add_argument("--max-epochs", type=int, default=140)
    p.add_argument("--nworkers", type=int, default=1)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num-iters", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    if args.nworkers > 1:
        raise SystemExit(
            f"--nworkers {args.nworkers}: the port trains on one card so "
            "far; multi-worker gTop-k over torch.distributed is the next "
            "slice")
    return TrainConfig(
        dnn=args.dnn, dataset=args.dataset, batch_size=args.batch_size,
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        compression=args.compression, density=args.density,
        topk_method=args.topk_method, nsteps_update=args.nsteps_update,
        max_epochs=args.max_epochs, nworkers=args.nworkers,
        data_dir=args.data_dir, seed=args.seed, device=args.device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    trainer = Trainer(config_from_args(args))
    stats = trainer.train(args.num_iters)
    print(json.dumps({
        "dnn": trainer.cfg.dnn,
        "compression": trainer.cfg.compression,
        "topk_method": trainer.cfg.topk_method,
        "device": str(trainer.device),
        "num_params": trainer.num_params,
        "losses": stats["losses"],
        "median_step_s": statistics.median(stats["step_times"]),
        "throughput": stats["throughput"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
