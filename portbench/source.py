"""The batch source the window feeds the trainer from.

The harness makes a pool of host batches from the seed at set-up, by the
configuration's kind (``pool`` of ``portbench/kinds/<kind>.py``: for the
image kinds, uint8 NHWC images and int32 labels at the configuration's
shapes), ``count`` distinct batches a rank, rank r's drawn from (seed,
r). ``PoolSource`` hands them to the port's ``Trainer`` through the
interface its stream reads, a dataset's ``epoch(e)``: every epoch yields
the pool in order, so no two consecutive steps share a batch while the
pool holds two or more. The trainer's own synthetic ImageNet draws a numpy generator for
each image on the host, which no user runs and which would pace every
ImageNet-shaped cell; this adapter is the one place the harness reaches
past ``TrainConfig``.

The pool stands for the job's dataset, so the trainer's epoch is the
dataset's (``epoch_samples``, ImageNet-1k's 1,281,167 training images),
not the synthetic stand-in's 1,024 images: the learning-rate schedule,
which steps at epoch boundaries (and recaptures a CUDA graph when it
does), is rebuilt on it.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


class PoolSource:
    """A dataset as ``Trainer._set_iters`` reads one: ``epoch(e)``
    yields the pool's batches in order."""

    def __init__(self, pool: List[Dict[str, np.ndarray]]):
        self.pool = pool

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        yield from self.pool


def attach(trainer, pool: List[Dict[str, np.ndarray]],
           epoch_samples: int) -> None:
    """Feed `trainer` from `pool`: set it as ``train_data``, give it the
    epoch of `epoch_samples` shared by its ranks (each rank's shard in
    whole batches), rebuild its schedule on that epoch, and rebuild the
    stream from epoch 0 (``_set_iters`` restarts the prefetcher)."""
    cfg = trainer.cfg
    trainer.train_data = PoolSource(pool)
    trainer.steps_per_epoch = max(1, epoch_samples // cfg.nworkers
                                  // (cfg.batch_size * cfg.nsteps_update))
    trainer.optimizer.schedule = trainer.lr_schedule()
    trainer._set_iters(0)
