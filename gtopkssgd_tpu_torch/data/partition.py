"""Deterministic per-rank data sharding (reference ``DataPartitioner``).

A copy of ``gtopkssgd_tpu/data/partition.py``: the port keeps its own so it
never imports the JAX package. Every rank derives the same permutation from
(seed, epoch) and takes its contiguous slice; the last rank absorbs the
remainder.
"""

from __future__ import annotations

import zlib

import numpy as np


def split_id(split: str) -> int:
    """Stable integer id for a split name, for RNG seeding (crc32: unlike
    ``hash()`` it is the same in every process)."""
    return zlib.crc32(split.encode())


#: Stream key for the split-INDEPENDENT part of a synthetic dataset (the
#: class signal): train and test must share it, or held-out eval on
#: synthetic data is chance-level.
SIGNAL_STREAM = 0xC1A55


def signal_rng(seed: int) -> np.random.Generator:
    """RNG for a synthetic dataset's split-independent class signal."""
    return np.random.default_rng(np.random.SeedSequence([seed, SIGNAL_STREAM]))


def partition_indices(
    n: int, rank: int, nworkers: int, seed: int = 0, epoch: int = 0
) -> np.ndarray:
    """This rank's disjoint slice of a shared permutation of range(n)."""
    if not 0 <= rank < nworkers:
        raise ValueError(f"rank {rank} out of range for {nworkers} workers")
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    perm = rng.permutation(n)
    per = n // nworkers
    lo = rank * per
    hi = (rank + 1) * per if rank < nworkers - 1 else n
    return perm[lo:hi]


class DataPartitioner:
    """(n, rank, nworkers, seed) -> the per-epoch index slice."""

    def __init__(self, n: int, rank: int = 0, nworkers: int = 1,
                 seed: int = 0):
        self.n = n
        self.rank = rank
        self.nworkers = nworkers
        self.seed = seed

    def indices(self, epoch: int = 0) -> np.ndarray:
        return partition_indices(
            self.n, self.rank, self.nworkers, self.seed, epoch
        )

    def __len__(self) -> int:
        per = self.n // self.nworkers
        return per if self.rank < self.nworkers - 1 else self.n - per * (
            self.nworkers - 1
        )
