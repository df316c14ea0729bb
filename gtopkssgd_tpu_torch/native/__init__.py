"""The host data prep in C++, the port's own copy of
``gtopkssgd_tpu/native``: ``src/dataprep.cpp`` (CIFAR's fused reflect-pad,
crop and flip over a batch, threaded across it; the Levenshtein distance
of the AN4 decode) behind ctypes.

The library is compiled with ``g++ -O3 -shared -fPIC -std=c++17 -pthread``
at first use, never at import, into ``gtopkssgd_tpu_torch/build/``, under
a name that carries a digest of the source and the flags, so an edited
source is rebuilt. Python and numpy draw all the randomness (crop offsets
and flip coins), so the native and numpy paths are bitwise equal. Where no
compiler is found the numpy path runs; ``available()`` says which path
runs, and the trainer's manifest records it (``native_dataprep``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "src" / "dataprep.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    text = SOURCE.read_bytes() + " ".join(FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:12]
    return BUILD_DIR / f"libdataprep-{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; raises on a failed build."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; None where it cannot be
    built (no g++)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.cifar_augment_batch.argtypes = [u8p, u8p, ctypes.c_int, i32p,
                                            i32p, u8p]
        lib.cifar_augment_batch.restype = None
        lib.edit_distance.argtypes = [i32p, ctypes.c_int, i32p,
                                      ctypes.c_int]
        lib.edit_distance.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def augment_numpy(images: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                  flips: np.ndarray) -> np.ndarray:
    """The numpy path: reflect-pad(4) + 32x32 crop at (ys, xs) +
    horizontal flip, uint8."""
    padded = np.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    out = np.empty_like(images)
    for i in range(images.shape[0]):
        crop = padded[i, ys[i]:ys[i] + 32, xs[i]:xs[i] + 32]
        out[i] = crop[:, ::-1] if flips[i] else crop
    return out


def cifar_augment_batch(images: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                        flips: np.ndarray) -> np.ndarray:
    """u8[B, 32, 32, 3] -> the fused pad, crop and flip, uint8 (raw
    pixels: the trainer normalizes on the device); the library where it
    is built, else ``augment_numpy``, bitwise the same."""
    images = np.ascontiguousarray(images, np.uint8)
    lib = load()
    if lib is None:
        return augment_numpy(images, ys, xs, flips)
    out = np.empty_like(images)
    lib.cifar_augment_batch(images, out, images.shape[0],
                            np.ascontiguousarray(ys, np.int32),
                            np.ascontiguousarray(xs, np.int32),
                            np.ascontiguousarray(flips, np.uint8))
    return out


def edit_distance_py(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance between two int sequences, in Python."""
    if not len(a):
        return len(b)
    if not len(b):
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance between two int sequences; the library where
    it is built, else ``edit_distance_py``."""
    lib = load()
    if lib is None:
        return edit_distance_py(a, b)
    aa = np.ascontiguousarray(a, np.int32)
    bb = np.ascontiguousarray(b, np.int32)
    return int(lib.edit_distance(aa, len(aa), bb, len(bb)))
