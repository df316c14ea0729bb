"""Fit the alpha-beta comm model that ``parallel.planner`` and
``parallel.bucketing`` price wires with, from point-to-point rounds
timed between two ranks.

    python -m gtopkssgd_tpu_torch.comm_probe [--out PATH]

Two ranks run the exchange a tree round runs (``collectives._ship``:
each rank sends a buffer to the other and receives one like it, one
``batch_isend_irecv``) on CUDA tensors at 1 KB ... 100 MB, over NCCL
with a rank on each of two cards where there are two or more, else over
gloo with both ranks on the one card (gloo stages CUDA tensors through
the host, as the trainer's ranks do when they share a card). The time of
a round is the median of host-clock rounds that each end in a device
sync. The fit, ``alpha_beta_fit`` (the grammar the JAX package's
``benchmarks/dcn_probe.py`` writes): alpha = the mean round time over
the small-message plateau (the sizes within 1.5x of the fastest), beta =
the largest size's rate once alpha is taken off. One link class is
measured, so the planner prices both hops of a plan (the in-slice and
the cross-slice one) from it. The JSON carries the card's name and power
limit, the backend and the rank layout; with ``--out`` it is written
there too. There is no CPU fallback: without a card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional, Sequence

import torch

SIZES = (1 << 10, 1 << 14, 1 << 18, 1 << 22, 1 << 24, 100_000_000)
WARMUP = 3


def _reps(nbytes: int) -> int:
    return 50 if nbytes <= 1 << 18 else 20 if nbytes <= 1 << 24 else 8


def probe_rank(device, sizes: Sequence[int]) -> List[dict]:
    """One of the two ranks: the median seconds of a round at each size
    (rank 0's clock is the one reported)."""
    import torch.distributed as dist

    from gtopkssgd_tpu_torch.parallel.collectives import _ship

    other = 1 - dist.get_rank()
    rows = []
    for nbytes in sizes:
        buf = torch.ones(nbytes // 4, dtype=torch.int32, device=device)
        times = []
        for i in range(WARMUP + _reps(nbytes)):
            dist.barrier()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            _ship(buf, other, other, dist.group.WORLD)
            torch.cuda.synchronize(device)
            if i >= WARMUP:
                times.append(time.perf_counter() - t0)
        rows.append({"bytes": int(buf.numel() * 4),
                     "round_s": statistics.median(times)})
    return rows


def fit_alpha_beta(rows: Sequence[dict]) -> dict:
    """alpha = mean round time over the small-message plateau (within 1.5x
    of the fastest size), beta = the largest size's bytes over its time
    less alpha, in Gbit/s."""
    pts = sorted(rows, key=lambda r: r["bytes"])
    floor = min(p["round_s"] for p in pts)
    plateau = [p["round_s"] for p in pts if p["round_s"] <= 1.5 * floor]
    alpha = sum(plateau) / len(plateau)
    big = pts[-1]
    beta_bps = big["bytes"] / max(big["round_s"] - alpha, 1e-9)
    return {
        "alpha_ms": alpha * 1e3,
        "beta_gbps": beta_bps * 8 / 1e9,
        "plateau_points": len(plateau),
        "points": [{"bytes": p["bytes"],
                    "measured_ms": p["round_s"] * 1e3,
                    "fitted_ms": (alpha + p["bytes"] / beta_bps) * 1e3}
                   for p in pts],
        "note": ("t(bytes) = alpha + bytes*8/beta_gbps/1e9 for one tree "
                 "round (send and receive at once); alpha = the "
                 "small-message plateau, beta = the large-transfer "
                 "asymptote"),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("comm_probe: no CUDA device visible; it measures the card",
              file=sys.stderr)
        return 2
    from gtopkssgd_tpu_torch.parallel.dist import spawn
    from gtopkssgd_tpu_torch.profile_step import card_identity

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    rows = spawn(probe_rank, 2, SIZES, backend=backend, device="cuda",
                 timeout=600)[0]
    doc = {
        "what": "alpha-beta fit of one point-to-point tree round between "
                "two ranks (gtopkssgd_tpu_torch.comm_probe)",
        "card": card_identity(),
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": backend,
        "ranks": ("2 ranks on cards 0 and 1" if backend == "nccl"
                  else "2 ranks sharing card 0, CUDA tensors staged "
                       "through the host"),
        "link_classes": ("one measured; the planner prices the in-slice "
                         "and the cross-slice hop both from it"),
        "alpha_beta_fit": fit_alpha_beta(rows),
    }
    text = json.dumps(doc, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
