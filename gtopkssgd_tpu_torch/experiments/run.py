"""Launch one registered experiment through the port's launch path.

    python -m gtopkssgd_tpu_torch.experiments.run cifar10_resnet20_gtopk
    python -m gtopkssgd_tpu_torch.experiments.run --list
    python -m gtopkssgd_tpu_torch.experiments.run imagenet_resnet50_gtopk \\
        --nworkers 1 --num-iters 100     # scale to the hardware at hand

Overrides are the root ``experiments.run``'s; anything not overridden
runs with the paper's configuration from the registry. ``--device``
(default ``cuda``) is the port's: ``cuda`` fails where no card is
visible, it never falls back to the CPU.

The port's ``Trainer`` is one rank, so an entry of P workers runs as P
rank processes through ``dist_trainer``'s own path (``parallel.dist.
spawn`` of ``dist_trainer._rank_run``): NCCL with one rank a card where
there are P cards, else gloo with the ranks sharing the card (or the
CPU). At P = 1 the experiment runs in this process (``dist_trainer.run``).
Either way the run ends with a ``done:`` log line: the train stats of
``dist_trainer.run``'s summary, with ``test()``'s after ``--num-iters``.
``--resume`` restores the newest checkpoint of ``--out-dir`` (the port's
``TrainConfig.resume``).

``resnet50_density_sweep`` (BASELINE.json config #5) runs the port's
harness, ``gtopkssgd_tpu_torch.benchmark --dnn resnet50``, once a density
in {1, 0.01, 0.001, 0.0001}: dense at 1, gtopk and allgather below.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import sys
from typing import List, Optional, Sequence, Tuple

from gtopkssgd_tpu_torch.experiments import EXPERIMENTS, SWEEP_NAME

SWEEP_DENSITIES = ("1", "0.01", "0.001", "0.0001")
OVERRIDES = ("nworkers", "batch_size", "max_epochs", "data_dir", "out_dir",
             "eval_batches", "log_interval")

log = logging.getLogger("gtopkssgd_tpu_torch.experiments")


def list_lines() -> List[str]:
    """``--list``: one line an entry, then the sweep, as the root
    runner prints them."""
    width = max(len(n) for n in EXPERIMENTS)
    lines = [f"{name:<{width}}  [{spec['_baseline']:>14}]  {spec['_desc']}"
             for name, spec in EXPERIMENTS.items()]
    lines.append(f"{SWEEP_NAME:<{width}}  [{'#5':>14}]  density sweep "
                 "{1, 0.01, 0.001, 0.0001} x ResNet-50 -> "
                 "gtopkssgd_tpu_torch.benchmark")
    return lines


def config(name: str, args: argparse.Namespace):
    """The port's ``TrainConfig`` of entry `name` under the overrides."""
    from gtopkssgd_tpu_torch.trainer import TrainConfig

    spec = {k: v for k, v in EXPERIMENTS[name].items()
            if not k.startswith("_")}
    for field in OVERRIDES:
        v = getattr(args, field)
        if v is not None:
            spec[field] = v
    return TrainConfig(**spec, resume=args.resume, device=args.device)


def launch(cfg, num_iters: Optional[int]) -> Tuple[int, dict]:
    """Run `cfg` through the port's launch path: (exit code, rank 0's
    summary)."""
    from gtopkssgd_tpu_torch import dist_trainer
    from gtopkssgd_tpu_torch.data.imagenet import prefork_decode_pool
    from gtopkssgd_tpu_torch.parallel.dist import shared_backend, spawn

    cfg.resolved()  # refuse a bad config before spawning ranks
    if cfg.nworkers == 1:
        outs = [dist_trainer.run(cfg, num_iters)]
    else:
        backend = shared_backend(cfg.nworkers, cfg.device)
        log.info("%d ranks over %s on %s", cfg.nworkers, backend, cfg.device)
        pool = dist_trainer.decode_pool_size(cfg)
        outs = spawn(dist_trainer._rank_run, cfg.nworkers, cfg, num_iters,
                     False, backend=backend, device=cfg.device,
                     setup=functools.partial(prefork_decode_pool, pool))
        outs[0]["dist_backend"] = backend
    return dist_trainer._finish(outs), outs[0]


def sweep(device: str) -> int:
    """BASELINE.json config #5: the port's harness once a density."""
    from gtopkssgd_tpu_torch import benchmark

    for density in SWEEP_DENSITIES:
        modes = "dense" if float(density) >= 1.0 else "gtopk,allgather"
        rc = benchmark.main(["--dnn", "resnet50", "--density", density,
                             "--modes", modes, "--topk-method", "auto",
                             "--device", device])
        if rc:
            return rc
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser("gtopkssgd_tpu_torch.experiments.run")
    ap.add_argument("name", nargs="?", help="experiment name (see --list)")
    ap.add_argument("--list", action="store_true", dest="list_all")
    ap.add_argument("--nworkers", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-epochs", type=int, default=None)
    ap.add_argument("--num-iters", type=int, default=None,
                    help="fixed step count instead of the full epoch run")
    ap.add_argument("--eval-batches", type=int, default=None)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-interval", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    if args.list_all or not args.name:
        for line in list_lines():
            print(line)
        return 0
    if args.name != SWEEP_NAME and args.name not in EXPERIMENTS:
        ap.error(f"unknown experiment {args.name!r} (try --list)")

    import torch

    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        raise SystemExit(f"{args.name}: --device {args.device} but no CUDA "
                         "device is visible (pass --device cpu to run on "
                         "the CPU)")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: "
                               "%(message)s")
    if args.name == SWEEP_NAME:
        return sweep(args.device)

    cfg = config(args.name, args)
    log.info("config: %s", json.dumps(dataclasses.asdict(cfg.resolved())))
    rc, out = launch(cfg, args.num_iters)
    if rc == 0:
        log.info("done: %s", json.dumps(out))
    return rc


if __name__ == "__main__":
    sys.exit(main())
