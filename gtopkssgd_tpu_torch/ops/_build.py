"""Build and load the hand-written CUDA kernels (``csrc/topk_kernels.cu``).

The source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds. The build happens at first use, never at import, into
``gtopkssgd_tpu_torch/build/`` (ignored by git). One source, one set of
flags, one library: its name carries a digest of the source and the flags,
so an edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "csrc" / "topk_kernels.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of every exported function.
SIGNATURES = {
    "gtopk_count": [_VP, _VP, _INT, _LL, _VP, _VP, _VP],
    "gtopk_stage1": [_VP, _VP, _LL, _INT, _VP, _VP, _VP, _VP, _VP],
    "gtopk_multisection": [_VP, _VP, _LL, _LL, _VP, _VP, _VP, _VP, _VP],
    "gtopk_noop": [_VP],
    "gtopk_threshold_apply": [_VP, _VP, _LL, _VP, _VP, _VP, _VP, _VP, _VP,
                              _VP],
    "gtopk_sgd_apply": [_VP, _VP, _INT, _LL, ctypes.c_float, ctypes.c_float,
                        ctypes.c_float, _INT, _INT, _INT, _INT, _VP],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    text = SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:12]
    return BUILD_DIR / f"lib{SOURCE.stem}-{digest}.so"


def build() -> Path:
    """Compile the source unless its library is already built."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {SOURCE.name} (rc {proc.returncode}):\n"
                f"{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call, its functions typed
    by SIGNATURES."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
