"""Seeded token sequences for the language models (``--dataset tokens``):
packed sequences of ``seq_len`` next-token pairs, the ids drawn Zipf(a)
over the vocabulary (``ZIPF_A``; rank r is id r - 1, ranks past the
vocabulary clipped to its last id), no file to read.

Sample i of a split is a pure function of (seed, split, i): ``seq_len +
1`` ids, of which the first ``seq_len`` are the tokens and the last
``seq_len`` the targets, int32 each. Ranks shard the samples as the image
datasets do (``partitioner``), epoch by epoch in a seeded order. A split
holds ``SAMPLES`` sequences; the harness feeds its own pool in their
place.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from gtopkssgd_tpu_torch.data.partition import DataPartitioner, split_id

SAMPLES = {"train": 64, "test": 8}
ZIPF_A = 1.1


class TokenDataset:
    def __init__(self, *, split: str = "train", batch_size: int = 4,
                 rank: int = 0, nworkers: int = 1,
                 data_dir: Optional[str] = None, seed: int = 0,
                 seq_len: int = 8192, vocab_size: int = 20480):
        self.split = "test" if split in ("val", "valid", "test") else split
        self.batch_size = batch_size
        self.seq_len, self.vocab_size = int(seq_len), int(vocab_size)
        self._seed = seed
        self.partitioner = DataPartitioner(SAMPLES[self.split], rank,
                                           nworkers, seed)
        if len(self.partitioner) < batch_size:
            raise ValueError(
                f"rank shard has {len(self.partitioner)} sequences < "
                f"batch_size {batch_size} — lower batch_size or nworkers")

    def steps_per_epoch(self) -> int:
        return len(self.partitioner) // self.batch_size

    def sample(self, i: int) -> np.ndarray:
        """Sample i's seq_len + 1 ids, int32."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self._seed, split_id(self.split), int(i)]))
        ranks = rng.zipf(ZIPF_A, self.seq_len + 1)
        return (np.minimum(ranks, self.vocab_size) - 1).astype(np.int32)

    def epoch(self, epoch: int = 0, batches: Optional[range] = None
              ) -> Iterator[Dict[str, np.ndarray]]:
        """One pass over this rank's shard: the batches numbered in
        `batches` (all when None), and only those are made."""
        idx = self.partitioner.indices(epoch)
        bs = self.batch_size
        for b in range(len(idx) // bs) if batches is None else batches:
            ids = np.stack([self.sample(i) for i in idx[b * bs:(b + 1) * bs]])
            yield {"tokens": ids[:, :-1], "targets": ids[:, 1:]}
