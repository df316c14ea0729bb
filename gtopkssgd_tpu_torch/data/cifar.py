"""CIFAR-10 pipeline (reference: torchvision CIFAR-10 with random-crop +
flip augmentation).

A copy of ``gtopkssgd_tpu/data/cifar.py`` (and of the numpy augmentation
of ``gtopkssgd_tpu/native``), so the port draws the same batches from the
same seed without importing the JAX package. Reads the python-pickle
batches (``cifar-10-batches-py``) under ``data_dir`` when present, else a
deterministic synthetic stand-in with the same shapes and a learnable class
signal. Batches are raw uint8 NHWC; the trainer normalizes on the device.
"""

from __future__ import annotations

import functools
import os
import pickle
from typing import Dict, Iterator

import numpy as np

from gtopkssgd_tpu_torch.data.partition import (
    DataPartitioner,
    signal_rng,
    split_id,
)

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
SYNTH_TRAIN, SYNTH_TEST = 2048, 512


@functools.lru_cache(maxsize=4)
def _load_real(data_dir: str, split: str):
    root = os.path.join(data_dir, "cifar-10-batches-py")
    files = (
        [f"data_batch_{i}" for i in range(1, 6)]
        if split == "train"
        else ["test_batch"]
    )
    images, labels = [], []
    for f in files:
        with open(os.path.join(root, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        images.append(
            d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        )
        labels.append(np.asarray(d[b"labels"], np.int32))
    return (
        np.ascontiguousarray(np.concatenate(images)),  # u8 raw pixels
        np.concatenate(labels),
    )


@functools.lru_cache(maxsize=8)
def _synthetic(split: str, seed: int):
    """Class-conditional Gaussian images with per-class channel offsets
    drawn from the split-independent signal stream."""
    n = SYNTH_TRAIN if split == "train" else SYNTH_TEST
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, split_id(split)]))
    labels = rng.integers(0, 10, n).astype(np.int32)
    offsets = (signal_rng(seed).standard_normal((10, 3))
               .astype(np.float32) * 0.25)
    signal = offsets[labels][:, None, None, :]
    images = 0.5 + 0.15 * rng.standard_normal(
        (n, 32, 32, 3)).astype(np.float32)
    images += signal
    images = np.clip(images, 0.0, 1.0)
    # quantize once to the uint8 wire format (what real pickles hold)
    return (images * 255.0).round().astype(np.uint8), labels


def cifar_augment_batch(images: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                        flips: np.ndarray) -> np.ndarray:
    """Reflect-pad(4) + 32x32 crop at (ys, xs) + horizontal flip, uint8."""
    padded = np.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    out = np.empty_like(images)
    for i in range(images.shape[0]):
        crop = padded[i, ys[i]:ys[i] + 32, xs[i]:xs[i] + 32]
        out[i] = crop[:, ::-1] if flips[i] else crop
    return out


class CIFAR10Dataset:
    num_classes = 10
    example_shape = (32, 32, 3)

    def __init__(self, *, split="train", batch_size=32, rank=0, nworkers=1,
                 data_dir=None, seed=0, augment=None):
        self.split = split
        self.batch_size = batch_size
        self.augment = (split == "train") if augment is None else augment
        root = data_dir or ""
        self.synthetic = not os.path.isdir(
            os.path.join(root, "cifar-10-batches-py")
        )
        if self.synthetic:
            self.images, self.labels = _synthetic(split, seed)
        else:
            self.images, self.labels = _load_real(root, split)
        self.partitioner = DataPartitioner(
            len(self.images), rank, nworkers, seed
        )
        if len(self.partitioner) < batch_size:
            raise ValueError(
                f"rank shard has {len(self.partitioner)} samples < "
                f"batch_size {batch_size} — lower batch_size or nworkers"
            )
        self._seed = seed
        self._rank = rank

    def steps_per_epoch(self) -> int:
        return len(self.partitioner) // self.batch_size

    def _augment(self, x: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        b = x.shape[0]
        ys = rng.integers(0, 9, b).astype(np.int32)
        xs = rng.integers(0, 9, b).astype(np.int32)
        flips = rng.random(b) < 0.5
        return cifar_augment_batch(x, ys, xs, flips)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """One pass over this rank's shard. Augmentation draws come from a
        generator seeded by (seed, rank, epoch), so batch b of epoch e is a
        pure function of those four values."""
        idx = self.partitioner.indices(epoch)
        rng = np.random.default_rng(
            np.random.SeedSequence([self._seed, self._rank + 1, epoch]))
        for lo in range(0, len(idx) - self.batch_size + 1, self.batch_size):
            sel = idx[lo:lo + self.batch_size]
            x = self.images[sel]
            if self.augment:
                x = self._augment(x, rng)
            yield {"image": x, "label": self.labels[sel]}

    def __iter__(self):
        """Endless stream across epochs."""
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1
