"""Threads per block of the multisection kernel, measured on the card.

    python -m gtopkssgd_tpu_torch.multisection_threads

Builds the kernel library once per fixed block width (WIDTHS threads:
``-DMS_THREADS=T -DMS_MIN_THREADS=T``) beside the shipped one, whose width
follows the source's rule (about 16 groups of 4 elements a thread, 128 to
512), one nvcc each, all started together. For each size in SIZES and each
mode (abs: |x|; residual: |x + r|) it checks that every width gives the
shipped library's lo, thresholds and counts bitwise, and prints the median
device time of REPS calls of each (CUDA events, a matmul queued ahead of
each call so the host's enqueue is not timed).

Needs a CUDA card.
"""

from __future__ import annotations

import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from gtopkssgd_tpu_torch.ops import _build, cuda_topk, k_for_density
from gtopkssgd_tpu_torch.profile_step import card_identity

WIDTHS = (128, 256, 512)
SIZES = (272_474, 2_000_000, 7_000_000, 25_557_032)
REPS = 20


def device_ms(fn) -> float:
    busy = torch.ones(4096, 4096, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        torch.mm(busy, busy)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("multisection_threads: needs a CUDA card", file=sys.stderr)
        return 2
    print(card_identity())
    variants = {"shipped": ()}
    for t in WIDTHS:
        variants[str(t)] = (f"-DMS_THREADS={t}", f"-DMS_MIN_THREADS={t}")
    with ThreadPoolExecutor(len(variants)) as pool:
        paths = list(pool.map(_build.build, variants.values()))
    libs = {name: _build.open_library(p) for name, p in zip(variants, paths)}
    shipped = _build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for n in SIZES:
            x = torch.randn(n, device="cuda", generator=gen)
            r = 0.3 * torch.randn(n, device="cuda", generator=gen)
            k = k_for_density(n, 0.001)
            for mode, res in (("abs", None), ("residual", r)):
                want, ms = None, {}
                for name, lib in libs.items():
                    _build._lib = lib  # the wrapper launches through it
                    got = cuda_topk.multisection_tau_lo(x, k, res)
                    want = want or got
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        print(f"n={n} {mode}: {name} threads differ from "
                              "the shipped library", file=sys.stderr)
                        return 1
                    ms[name] = device_ms(
                        lambda: cuda_topk.multisection_tau_lo(x, k, res))
                print(f"n={n:>10,d} {mode:8s} ms by threads: "
                      + " ".join(f"{name}:{v:.5f}" for name, v in ms.items())
                      + " (bitwise equal)")
    finally:
        _build._lib = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
