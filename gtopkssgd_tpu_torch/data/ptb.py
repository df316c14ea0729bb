"""Penn Treebank pipeline, the port's copy of ``gtopkssgd_tpu/data/ptb.py``:
bit for bit the JAX pipeline's batches, without importing the JAX package.

Standard LM batching: the whole split is one token stream, chopped into
``batch_size * nworkers`` parallel rows; a batch is a ``bptt``-token window
of this rank's ``batch_size`` rows, (tokens i32[B, T], targets i32[B, T])
with targets the tokens shifted by one. The recurrent carry crosses
consecutive windows (the trainer zeroes it at each epoch), so ranks shard
by stream rows, not by a permutation: rank r owns rows [rB, (r+1)B) of
every window, and the dataset has no ``partitioner``.

The real path reads ``ptb.{train,valid,test}.txt`` under ``data_dir``
(word level, newlines as ``<eos>``, the vocabulary built from train, unknown
words as ``<unk>``). Without them: a Zipf-distributed token stream over the
full 10,000-word vocabulary, made from (seed, split).
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Iterator, Optional

import numpy as np

from gtopkssgd_tpu_torch.data.partition import split_id

VOCAB_SIZE = 10000
SYNTH_TOKENS = {"train": 200_000, "valid": 40_000, "test": 40_000}


@functools.lru_cache(maxsize=4)
def _synth_tokens(split: str, seed: int) -> np.ndarray:
    """The Zipf stream of a split; cached, so ranks in one process share
    it."""
    rng = np.random.default_rng(np.random.SeedSequence([seed,
                                                        split_id(split)]))
    stream = rng.zipf(1.3, SYNTH_TOKENS[split]).astype(np.int64)
    return np.clip(stream, 1, VOCAB_SIZE - 1).astype(np.int32)


class PTBDataset:
    bptt_default = 35

    def __init__(self, *, split="train", batch_size=20, rank=0, nworkers=1,
                 data_dir=None, seed=0, bptt=35):
        self.split = "valid" if split in ("val", "valid") else split
        self.batch_size = batch_size
        self.bptt = bptt
        path = os.path.join(data_dir or "", f"ptb.{self.split}.txt")
        self.synthetic = not os.path.isfile(path)
        if self.synthetic:
            self.tokens = _synth_tokens(self.split, seed)
            self.vocab_size = VOCAB_SIZE
            self.vocab: Optional[Dict[str, int]] = None
        else:
            self.vocab = self._build_vocab(
                os.path.join(data_dir or "", "ptb.train.txt"))
            self.vocab_size = len(self.vocab)
            self.tokens = self._tokenize(path)
        rows = batch_size * nworkers
        total = (len(self.tokens) - 1) // rows * rows
        usable = self.tokens[:total + 1]
        self.row_len = total // rows
        grid = usable[:-1].reshape(rows, self.row_len)
        tgt = usable[1:].reshape(rows, self.row_len)
        lo, hi = rank * batch_size, (rank + 1) * batch_size
        self.inputs = grid[lo:hi]
        self.targets = tgt[lo:hi]
        if self.row_len < self.bptt:
            raise ValueError(
                f"rows of {self.row_len} tokens are shorter than one "
                f"bptt window ({self.bptt}) — lower batch_size or nworkers")

    @staticmethod
    def _build_vocab(train_path: str) -> Dict[str, int]:
        with open(train_path) as f:
            words = f.read().replace("\n", " <eos> ").split()
        vocab = {"<unk>": 0}
        for w in sorted(set(words)):
            vocab.setdefault(w, len(vocab))
        return vocab

    def _tokenize(self, path: str) -> np.ndarray:
        with open(path) as f:
            words = f.read().replace("\n", " <eos> ").split()
        unk = self.vocab.get("<unk>", 0)
        return np.asarray([self.vocab.get(w, unk) for w in words], np.int32)

    def steps_per_epoch(self) -> int:
        return self.row_len // self.bptt

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The windows of one pass, in stream order (the same every
        epoch)."""
        for lo in range(0, self.row_len - self.bptt + 1, self.bptt):
            yield {"tokens": self.inputs[:, lo:lo + self.bptt],
                   "targets": self.targets[:, lo:lo + self.bptt]}

    def __iter__(self):
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1
