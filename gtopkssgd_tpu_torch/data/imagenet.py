"""ImageNet pipeline, the port of ``gtopkssgd_tpu/data/imagenet.py``.

Real path: ``data_dir/{train,val}/<wnid>/*.JPEG`` (ImageFolder layout)
decoded with PIL: a random-resized crop to 224 and a flip for train,
resize-256 and a center crop to 224 for eval. Each image draws from its
own rng, seeded from (seed, split, epoch, index), so a batch is a pure
function of those whatever the decode pool's size, and a mid-epoch seek
(``epoch(e, batches=)``) decodes only the listed batches. Bit for bit the
JAX pipeline's batches: both sides call the same PIL and numpy code on
the same rng stream.

``decode_workers`` > 0 decodes through a pool of forked processes, one a
process, shared by every dataset that asks and refcounted
(``close()`` drops a dataset's reference; the last one terminates the
pool). The pool forks when the first dataset is built, so build the
datasets before the process makes its first CUDA call, starts a thread
(the prefetcher) or joins a process group (``prefork_decode_pool`` lets a
rank process fork it even before that); the children run only PIL and
numpy. At P ranks, one process a rank, there are P pools.

Synthetic stand-in (no such folder, or no ``data_dir``): class-conditional
uint8 noise at full 224x224, made per index from the seed, so ResNet-50
and AlexNet train at their true compute shape with no files.

Batches are raw uint8 NHWC; the trainer normalizes on the device. PIL is
imported inside the decode function only.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from gtopkssgd_tpu_torch.data.partition import (
    DataPartitioner,
    signal_rng,
    split_id,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
SYNTH_TRAIN, SYNTH_TEST = 1024, 256


@functools.lru_cache(maxsize=4)
def _index_folder(root: str) -> Tuple[List[str], np.ndarray, List[str]]:
    """(paths, labels, classes) of an ImageFolder split: classes are the
    sorted subdirectories, files sorted within each."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for ci, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith((".jpeg", ".jpg", ".png")):
                paths.append(os.path.join(cdir, f))
                labels.append(ci)
    return paths, np.asarray(labels, np.int32), classes


def _decode_image(path: str, size: int, train: bool, rng) -> np.ndarray:
    """One image decoded, cropped (and flipped) to uint8 [size, size, 3]:
    train, a random-resized crop (area 8%-100%, aspect 3/4..4/3, ten
    tries, else a plain resize) and a flip with probability 0.5; eval,
    the short side resized to 256 and a center crop. All randomness
    comes from `rng`. Module level, so the pool can pickle it."""
    from PIL import Image

    s = size
    with Image.open(path) as im:
        im = im.convert("RGB")
        if train:
            w, h = im.size
            for _ in range(10):
                area = w * h * rng.uniform(0.08, 1.0)
                ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
                cw = int(round(np.sqrt(area * ar)))
                ch = int(round(np.sqrt(area / ar)))
                if cw <= w and ch <= h:
                    x0 = rng.integers(0, w - cw + 1)
                    y0 = rng.integers(0, h - ch + 1)
                    im = im.resize((s, s), box=(x0, y0, x0 + cw, y0 + ch))
                    break
            else:
                im = im.resize((s, s))
            arr = np.asarray(im, np.uint8)
            if rng.random() < 0.5:
                arr = arr[:, ::-1]
        else:
            w, h = im.size
            scale = 256 / min(w, h)
            im = im.resize((int(w * scale), int(h * scale)))
            w, h = im.size
            x0, y0 = (w - s) // 2, (h - s) // 2
            arr = np.asarray(im, np.uint8)[y0:y0 + s, x0:x0 + s]
    return arr


def _decode_seeded(args) -> np.ndarray:
    """One image with its own rng from ``seed_key`` = (seed, split,
    epoch, index): the same bytes in any process and any pool size."""
    path, size, train, seed_key = args
    rng = np.random.default_rng(np.random.SeedSequence(seed_key))
    return _decode_image(path, size, train, rng)


# One decode pool a process, refcounted: the train and val sets of a
# trainer share it (they are drained one after the other). Its size is the
# first acquirer's; per-image seeding makes the batches independent of it.
_pool_lock = threading.Lock()
_pool = None
_pool_refs = 0


def _acquire_decode_pool(n: int):
    global _pool, _pool_refs
    import multiprocessing as mp

    with _pool_lock:
        if _pool is None:
            _pool = mp.get_context("fork").Pool(n)
        _pool_refs += 1
        return _pool


def _release_decode_pool() -> None:
    global _pool, _pool_refs
    with _pool_lock:
        _pool_refs -= 1
        if _pool_refs <= 0 and _pool is not None:
            _pool.terminate()
            _pool.join()
            _pool = None
            _pool_refs = 0


def decode_pool_refs() -> int:
    """References held on this process's decode pool (0: no pool)."""
    return _pool_refs if _pool is not None else 0


def prefork_decode_pool(n: int) -> Callable[[], None]:
    """Fork this process's decode pool of `n` workers now (nothing when
    `n` is 0) and return the function that drops this reference: a rank
    process calls it before it joins its process group, so the fork sees
    none of the group's threads."""
    if n <= 0:
        return lambda: None
    _acquire_decode_pool(n)
    return _release_decode_pool


class ImageNetDataset:
    example_shape = (224, 224, 3)

    def __init__(self, *, split="train", batch_size=32, rank=0, nworkers=1,
                 data_dir=None, seed=0, image_size=224, num_classes=1000,
                 decode_workers=0):
        self.split = split
        self.batch_size = batch_size
        self.image_size = image_size
        self.train = split == "train"
        root = os.path.join(data_dir or "", "train" if self.train else "val")
        self.synthetic = not os.path.isdir(root)
        self._seed = seed
        if self.synthetic:
            self.num_classes = num_classes
            n = SYNTH_TRAIN if self.train else SYNTH_TEST
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, split_id(split)]))
            self._labels = rng.integers(0, num_classes, n).astype(np.int32)
            # Split-independent class offsets: train and val share the
            # class signal, or held-out eval on synthetic data is chance.
            self._offsets = (signal_rng(seed).standard_normal(
                (num_classes, 3)).astype(np.float32) * 0.25)
            self._paths = None
            count = n
        else:
            self._paths, self._labels, classes = _index_folder(root)
            self.num_classes = len(classes)
            count = len(self._paths)
        self.partitioner = DataPartitioner(count, rank, nworkers, seed)
        if len(self.partitioner) < batch_size:
            raise ValueError(
                f"rank shard has {len(self.partitioner)} samples < "
                f"batch_size {batch_size} — lower batch_size or nworkers")
        if decode_workers < 0:
            raise ValueError(f"decode_workers={decode_workers} must be >= 0")
        self.decode_workers = 0 if self.synthetic else int(decode_workers)
        # Acquired here, at construction: see the module docstring.
        self._pool = (_acquire_decode_pool(self.decode_workers)
                      if self.decode_workers > 0 else None)

    def close(self) -> None:
        """Drop this dataset's reference on the decode pool (the last
        holder's release terminates it). Safe to call again."""
        if self._pool is not None:
            self._pool = None
            _release_decode_pool()

    def steps_per_epoch(self) -> int:
        return len(self.partitioner) // self.batch_size

    def _jobs(self, sel: np.ndarray, epoch: int) -> list:
        tag = split_id(self.split)
        return [(self._paths[i], self.image_size, self.train,
                 (self._seed, tag, int(epoch), int(i))) for i in sel]

    def _decode_batch(self, sel: np.ndarray, epoch: int) -> np.ndarray:
        jobs = self._jobs(sel, epoch)
        if self._pool is not None:
            return np.stack(self._pool.map(_decode_seeded, jobs))
        return np.stack([_decode_seeded(job) for job in jobs])

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
        `batches` (all when None), and only those are made."""
        idx = self.partitioner.indices(epoch)
        bs = self.batch_size
        for b in range(len(idx) // bs) if batches is None else batches:
            sel = idx[b * bs:(b + 1) * bs]
            x = (self._synth_batch(sel) if self.synthetic
                 else self._decode_batch(sel, epoch))
            yield {"image": x, "label": self._labels[sel]}

    def __iter__(self):
        """Endless stream across epochs."""
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1
