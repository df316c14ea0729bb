"""ImageNet pipeline, the port of ``gtopkssgd_tpu/data/imagenet.py``'s
synthetic stand-in: class-conditional uint8 noise at full 224x224, made
per index from the seed, so ResNet-50 and AlexNet train at their true
compute shape with no files. Bit for bit the JAX pipeline's batches
(labels, class offsets, images, shard order).

The real-JPEG path (``data_dir/{train,val}/<wnid>/*.JPEG`` decoded with
PIL, with its worker pool) is not ported yet: a ``data_dir`` that holds
such a folder raises rather than falling back to synthetic data.
Batches are raw uint8 NHWC; the trainer normalizes on the device.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np

from gtopkssgd_tpu_torch.data.partition import (
    DataPartitioner,
    signal_rng,
    split_id,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
SYNTH_TRAIN, SYNTH_TEST = 1024, 256


class ImageNetDataset:
    example_shape = (224, 224, 3)

    def __init__(self, *, split="train", batch_size=32, rank=0, nworkers=1,
                 data_dir=None, seed=0, image_size=224, num_classes=1000):
        self.split = split
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        subdir = "train" if split == "train" else "val"
        if data_dir is not None and os.path.isdir(
                os.path.join(data_dir, subdir)):
            raise NotImplementedError(
                f"{os.path.join(data_dir, subdir)}: the port reads no "
                "ImageNet JPEG folder yet (only the synthetic stand-in, "
                "with no --data-dir)")
        self._seed = seed
        n = SYNTH_TRAIN if split == "train" else SYNTH_TEST
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, split_id(split)]))
        self._labels = rng.integers(0, num_classes, n).astype(np.int32)
        # Split-independent class offsets: train and val share the class
        # signal, or held-out eval on synthetic data is chance.
        self._offsets = (signal_rng(seed).standard_normal((num_classes, 3))
                         .astype(np.float32) * 0.25)
        self.partitioner = DataPartitioner(n, rank, nworkers, seed)
        if len(self.partitioner) < batch_size:
            raise ValueError(
                f"rank shard has {len(self.partitioner)} samples < "
                f"batch_size {batch_size} — lower batch_size or nworkers")

    def steps_per_epoch(self) -> int:
        return len(self.partitioner) // self.batch_size

    def _synth_batch(self, sel: np.ndarray) -> np.ndarray:
        """Sample i is a pure function of (seed, split, i): uint8 noise
        from ``integers`` plus the class's channel shift."""
        s = self.image_size
        out = np.empty((len(sel), s, s, 3), np.int16)
        for j, i in enumerate(sel):
            rng = np.random.default_rng(np.random.SeedSequence(
                [self._seed, split_id(self.split), int(i)]))
            out[j] = rng.integers(64, 192, (s, s, 3), dtype=np.int16)
        shift = (self._offsets[self._labels[sel]] * 255).astype(np.int16)
        out += shift[:, None, None, :]
        return np.clip(out, 0, 255).astype(np.uint8)

    def epoch(self, epoch: int = 0, batches: Optional[range] = None
              ) -> Iterator[Dict[str, np.ndarray]]:
        """One pass over this rank's shard: the batches numbered in
        `batches` (all when None), and only those are synthesized."""
        idx = self.partitioner.indices(epoch)
        bs = self.batch_size
        for b in range(len(idx) // bs) if batches is None else batches:
            sel = idx[b * bs:(b + 1) * bs]
            yield {"image": self._synth_batch(sel),
                   "label": self._labels[sel]}

    def __iter__(self):
        """Endless stream across epochs."""
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1
