"""Command line of the port's trainer (the JAX package's flag names).

    python -m gtopkssgd_tpu_torch.dist_trainer \\
        --dnn resnet20|resnet56|vgg16|resnet50|alexnet|lstm|lstman4 \\
        [--dataset cifar10|imagenet|ptb|an4] [--s2d] \\
        --compression gtopk --density 0.001 --topk-method twostage \\
        [--num-iters 20] [--eval-batches B] [--nworkers P] [--device cpu] \\
        [--dist-backend gloo] [--wire-codec int8] [--momentum-correction] \\
        [--nesterov] [--clip-grad-norm C] [--warmup-epochs E] \\
        [--dense-warmup-epochs E]

Runs on the CUDA card unless ``--device cpu``. ``--nworkers P`` above 1
spawns P rank processes joined in one process group: NCCL with one rank
per card by default on CUDA (P cards needed), gloo on the CPU;
``--dist-backend gloo`` with ``--device cuda`` lets the ranks share the
visible cards. With ``--num-iters N`` the trainer takes N steps and then
evaluates (``Trainer.test()``, at most ``--eval-batches`` batches);
without it, ``Trainer.fit()`` trains and evaluates each of
``--max-epochs`` epochs, as the JAX CLI does. The dataset defaults to the
model's (``lstm``: PTB, ``lstman4``: AN4; synthetic unless ``--data-dir``
holds the real files), and so do lr, weight decay and the clip (PTB 1.0,
0, 0.25; AN4 3e-4, 0, 400). Rank 0 prints one JSON line with the
per-step losses, step times, the gradient bytes a rank shipped per step
and the validation metrics (``val_loss`` and ``val_top1``/``val_top5``,
``val_ppl``, or ``val_cer``/``val_wer``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from typing import Optional, Sequence

from gtopkssgd_tpu_torch.parallel import collectives
from gtopkssgd_tpu_torch.parallel.dist import (
    BACKENDS,
    default_backend,
    rank_device,
    spawn,
)
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
    p.add_argument("--nesterov", action="store_true")
    p.add_argument("--compression", default=None,
                   choices=["none", "dense", "gtopk", "allgather", "topk"],
                   help="None/dense = all-reduce baseline; gtopk = tree "
                        "sparse all-reduce; allgather/topk = the Top-k "
                        "union of every rank's picks")
    p.add_argument("--density", type=float, default=0.001)
    p.add_argument("--topk-method", default="auto",
                   help="auto | exact | threshold | pallas | twostage")
    p.add_argument("--wire-codec", default="fp32",
                   help="on-wire sparse-set codec: fp32 (identity), "
                        "int8[:BLOCK] or fp8[:BLOCK] (block-scaled values, "
                        "bf16 scales, Elias-Fano indices; BLOCK defaults "
                        "to 64); the quantization error folds into the "
                        "error-feedback residual")
    p.add_argument("--clip-grad-norm", type=float, default=None)
    p.add_argument("--nsteps-update", type=int, default=1)
    p.add_argument("--max-epochs", type=int, default=140)
    p.add_argument("--warmup-epochs", type=int, default=0,
                   help="linear LR ramp over the first N epochs")
    p.add_argument("--dense-warmup-epochs", type=int, default=0,
                   help="sparse modes: communicate dense for the first N "
                        "epochs before enabling top-k")
    p.add_argument("--momentum-correction", action="store_true",
                   help="sparse modes: DGC momentum correction and factor "
                        "masking (the velocity accumulates before "
                        "selection)")
    p.add_argument("--nworkers", type=int, default=1)
    p.add_argument("--dist-backend", default=None, choices=BACKENDS,
                   help="default: nccl on cuda, gloo on cpu")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--s2d", action="store_true",
                   help="resnet50: space-to-depth stem (4x4x12 conv on 2x2 "
                        "pixel blocks)")
    p.add_argument("--num-iters", type=int, default=None,
                   help="train a fixed number of steps instead of epochs")
    p.add_argument("--eval-batches", type=int, default=None,
                   help="cap on the validation batches (default: all)")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        dnn=args.dnn, dataset=args.dataset, batch_size=args.batch_size,
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        nesterov=args.nesterov, compression=args.compression,
        density=args.density, topk_method=args.topk_method,
        wire_codec=args.wire_codec, clip_grad_norm=args.clip_grad_norm,
        nsteps_update=args.nsteps_update, max_epochs=args.max_epochs,
        warmup_epochs=args.warmup_epochs,
        dense_warmup_epochs=args.dense_warmup_epochs,
        momentum_correction=args.momentum_correction,
        space_to_depth=args.s2d, eval_batches=args.eval_batches,
        nworkers=args.nworkers, data_dir=args.data_dir, seed=args.seed,
        device=args.device)


def run(cfg: TrainConfig, num_iters: Optional[int]) -> dict:
    """On this process (one rank): train `num_iters` steps and evaluate,
    or ``fit()`` when `num_iters` is None; summarize."""
    trainer = Trainer(cfg)
    collectives.reset_wire()
    if num_iters is not None:
        stats = {**trainer.train(num_iters), **trainer.test()}
    else:
        stats = trainer.fit()
    return {
        "dnn": trainer.cfg.dnn,
        "compression": trainer.cfg.compression,
        "topk_method": trainer.cfg.topk_method,
        "wire_codec": trainer.cfg.wire_codec,
        "device": str(trainer.device),
        "nworkers": trainer.cfg.nworkers,
        "num_params": trainer.num_params,
        "losses": stats["losses"],
        "median_step_s": statistics.median(stats["step_times"]),
        "throughput": stats["throughput"],
        "wire_bytes_per_step": collectives.wire["bytes"] / max(1,
                                                               trainer.step),
        **{key: stats[key] for key in stats if key.startswith("val_")},
    }


def _rank_run(device, cfg: TrainConfig, num_iters: Optional[int]) -> dict:
    return run(dataclasses.replace(cfg, device=str(device)), num_iters)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)
    if args.nworkers > 1:
        backend = args.dist_backend or default_backend(args.device)
        try:
            rank_device(0, args.nworkers, backend, args.device)
        except ValueError as e:
            raise SystemExit(f"--nworkers {args.nworkers}: {e}") from None
        out = spawn(_rank_run, args.nworkers, cfg, args.num_iters,
                    backend=backend, device=args.device)[0]
        out["dist_backend"] = backend
    else:
        out = run(cfg, args.num_iters)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
