"""The stage-1 candidate kernel's design, checked and measured on the card.

    python -m gtopkssgd_tpu_torch.stage1_design

Builds the kernel library once per variant of ``stage1_kernel`` (VARIANTS:
nvcc ``-D`` defines through ``_build.build``) beside the shipped one, one
nvcc each, all started together:

* ``wps1`` / ``wps2`` / ``wps4``: 1, 2 or 4 warps to a slab in place of 8;
  at groups 64 a warp then reads 32, 16 or 8 rows of its slab in 8, 4 or
  2 batches of loads, and 8, 4 or 2 slabs share a block;
* ``batch8``: 8 rows of loads in flight a thread in place of 4;
* ``onespan`` / ``persist``: a block a span, or a grid of at most the
  blocks the card holds at once walking the spans grid-stride, with and
  without counts alike, in place of the shipped rule (a block a span
  without counts, persistent with);
* ``bulk``: each span (one slab at groups 64) copied into a 4-stage ring
  of shared memory by ``cp.async.bulk`` on an mbarrier, one block an SM,
  in place of the threads' 16-byte loads.

Every variant is held bitwise to the plain twin on ``edge_cases`` and at
each size in SIZES, then timed there (median of REPS calls, CUDA events, a
matmul queued ahead of each call so the host's enqueue is not timed),
without and with the 8 counts, beside the bytes bound, an empty kernel's
launch (``launch_floor``) and the bytes floor: the same bytes read and
written by one float4 a thread with no selection (``gtopk_bytes_floor``).

``edge_cases`` and ``stage1_mismatch`` also serve ``chip_smoke.py`` and the
card tests. Needs a CUDA card to run as a script.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from gtopkssgd_tpu_torch.ops import _build, cuda_topk, k_for_density, topk

VARIANTS = {
    "shipped": (),
    **{f"wps{w}": (f"-DSTAGE1_WPS={w}",) for w in (1, 2, 4)},
    "batch8": ("-DSTAGE1_BATCH=8",),
    "onespan": ("-DSTAGE1_GRID=1",),
    "persist": ("-DSTAGE1_GRID=2",),
    "bulk": ("-DSTAGE1_BULK=1",),
}
SIZES = (272_474, 2_000_000, 7_000_000, 25_557_032)
REPS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
EDGE_SIZES = (1, 127, 1000, 262_143, 262_145)
EDGE_GROUPS = (1, 8, 64, 2048)


def tie_input(n: int, groups: int,
              seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(grad, residual) f32[n] whose sums repeat a few magnitudes with both
    signs, and in which lane l of slab 0 holds +-8 at rows 0 and rpg - 1,
    and of slab 1 (slab 0 at groups 1) at rows rpg/2 - 1 and rpg/2, the
    two signs opposite and swapped from lane to lane: the bucket's maximum
    is a tie, and the first row must win whichever warp reads it. Sums of
    these dyadic values are exact. n >= 2 * 262144 / groups."""
    rng = np.random.default_rng(seed)
    levels = np.array([0.0, 0.5, 1.0, 2.0, 3.0], np.float32)
    g = (rng.choice(levels, n) * rng.choice([-1, 1], n)).astype(np.float32)
    r = (rng.choice([0.0, 0.5], n) * rng.choice([-1, 1], n)).astype(
        np.float32)
    rpg = cuda_topk.BLOCK_ROWS // groups
    second = rpg * cuda_topk.LANES if groups > 1 else 0
    lanes = np.arange(cuda_topk.LANES)
    sign = np.where(lanes % 2 == 1, 8.0, -8.0).astype(np.float32)
    for base, first, last in ((0, 0, rpg - 1),
                              (second, rpg // 2 - 1, rpg // 2)):
        if first == last:
            continue
        for row, s in ((first, sign), (last, -sign)):
            idx = base + row * cuda_topk.LANES + lanes
            g[idx], r[idx] = s, 0.0
    return g, r


def nan_input(n: int, groups: int, seed: int = 0,
              inf: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(grad, residual) f32[n], normal draws with NaNs placed against the
    NaN rules (``ops.cuda_topk``): in slab 0, every third lane holds NaN at
    rows 1 and rpg - 1 (the first must win, whichever warp reads it), lane
    5 a NaN in the residual only, lane 10 a NaN with the sign bit set;
    with `inf`, lane 11 holds +inf at row 0 and NaN at row rpg - 1 (the
    NaN wins) and lane 13 -inf alone; then 1% of all elements NaN.
    n >= 262144 / groups."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    r = (0.3 * rng.standard_normal(n)).astype(np.float32)
    rpg = cuda_topk.BLOCK_ROWS // groups

    def at(row: int, lane: int) -> int:
        return min(row, rpg - 1) * cuda_topk.LANES + lane

    for lane in range(0, cuda_topk.LANES, 3):
        g[at(1, lane)] = g[at(rpg - 1, lane)] = np.nan
    r[at(3, 5)] = np.nan
    g[at(0, 10)] = np.copysign(np.float32(np.nan), np.float32(-1.0))
    if inf:
        g[at(0, 11)], g[at(rpg - 1, 11)] = np.inf, np.nan
        g[at(0, 13)] = -np.inf
    g[rng.random(n) < 0.01] = np.nan
    return g, r


def nan_cases(device: torch.device | str, seed: int = 0,
              inf: bool = True) -> Iterator[Tuple[str, torch.Tensor,
                                                  torch.Tensor, int]]:
    """(label, grad, residual, groups) on `device` holding NaNs:
    ``nan_input`` at groups 8 and 64 (with `inf`, also infinities), an
    all-NaN gradient (an injected ``nan_grad``) at n = 1000 and groups 8,
    and a NaN view one float into its buffer."""
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    for groups in (8, 64):
        g, r = nan_input(272_474, groups, seed, inf=inf)
        yield "n=272474 nan", dev(g), dev(r), groups
    r = (0.3 * np.random.default_rng(seed).standard_normal(1000)).astype(
        np.float32)
    yield "n=1000 all nan", dev(np.full(1000, np.nan, np.float32)), dev(r), 8
    g, r = nan_input(262_146, 64, seed + 1, inf=inf)
    yield "n=262145 nan unaligned x[1:]", dev(g)[1:], dev(r)[1:], 64


def edge_cases(device: torch.device | str,
               seed: int = 0) -> Iterator[Tuple[str, torch.Tensor,
                                                torch.Tensor, int]]:
    """(label, grad, residual, groups) on `device`: every n in EDGE_SIZES at
    every groups in EDGE_GROUPS; views one float into their buffers
    (``x[1:]``, not 16-byte aligned); ``tie_input`` at groups 8 and 64;
    and ``nan_cases``."""
    rng = np.random.default_rng(seed)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    for n in EDGE_SIZES:
        for groups in EDGE_GROUPS:
            g = rng.standard_normal(n).astype(np.float32)
            r = (0.3 * rng.standard_normal(n)).astype(np.float32)
            yield f"n={n}", dev(g), dev(r), groups
    for n, groups in ((272_474, 64), (262_145, 8), (1000, 2048)):
        g = rng.standard_normal(n + 1).astype(np.float32)
        r = (0.3 * rng.standard_normal(n + 1)).astype(np.float32)
        yield f"n={n} unaligned x[1:]", dev(g)[1:], dev(r)[1:], groups
    for groups in (8, 64):
        g, r = tie_input(272_474, groups, seed)
        yield "n=272474 ties", dev(g), dev(r), groups
    yield from nan_cases(device, seed)


def thresholds_for(mag: torch.Tensor) -> torch.Tensor:
    """8 thresholds over `mag`: 6 quantiles of its non-NaN values and two
    of its values."""
    q = torch.nanquantile(mag[:1 << 24], torch.tensor(
        [0.05, 0.3, 0.5, 0.7, 0.9, 0.99], device=mag.device))
    return torch.cat([q, mag[:1], mag[mag.shape[0] // 2:][:1]]).contiguous()


def bits(t: torch.Tensor) -> torch.Tensor:
    """`t` as integers: a float32 tensor's bit patterns (NaNs compare)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether `a` and `b` are bitwise equal, NaNs included."""
    return a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def stage1_mismatch(g: torch.Tensor, r: Optional[torch.Tensor],
                    groups: int) -> Optional[str]:
    """None when the kernel gives its twin's candidates bitwise, without
    and with the 8 counts; else what differs."""
    thr = thresholds_for((g if r is None else g + r).abs())
    for t in (None, thr):
        got = cuda_topk.fused_stage1_candidates(g, t, r, groups=groups)
        want = cuda_topk.fused_stage1_candidates_ref(g, t, r, groups=groups)
        for name, a, b in zip(("values", "indices", "counts"), got, want):
            if (a is None) != (b is None):
                return f"{name}: one side is None"
            if a is not None and not same_bits(a, b):
                at = (bits(a) != bits(b)).nonzero()[:4].flatten().tolist()
                counts = "off" if t is None else "on"
                return (f"{name} differ (counts {counts}) at {at}: "
                        f"{a[at].tolist()} vs twin {b[at].tolist()}")
    return None


def main() -> int:
    if not torch.cuda.is_available():
        print("stage1_design: needs a CUDA card", file=sys.stderr)
        return 2
    from gtopkssgd_tpu_torch.multisection_threads import device_ms
    from gtopkssgd_tpu_torch.profile_step import card_identity

    print(card_identity())
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = list(pool.map(_build.build, VARIANTS.values()))
    libs = {name: _build.open_library(p) for name, p in zip(VARIANTS, paths)}
    shipped = _build.load()
    dev = torch.device("cuda")
    floor = device_ms(lambda: cuda_topk.launch_floor(dev))
    print(f"launch_floor_ms={floor:.5f} (empty kernel)")
    edges = list(edge_cases(dev))
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for n in SIZES:
        g = torch.randn(n, device="cuda", generator=gen)
        r = 0.3 * torch.randn(n, device="cuda", generator=gen)
        data[n] = (g, r, topk._twostage_pallas_groups(
            n, k_for_density(n, 0.001)))
    try:
        for name, lib in libs.items():
            _build._lib = lib  # the wrapper launches through it
            for label, g, r, groups in edges + [
                    (f"n={n}", g, r, groups)
                    for n, (g, r, groups) in data.items()]:
                bad = stage1_mismatch(g, r, groups)
                if bad is not None:
                    print(f"{name}: {label} groups={groups}: {bad}",
                          file=sys.stderr)
                    return 1
            print(f"{name}: bitwise equal to the twin on {len(edges)} edge "
                  f"cases and at {len(SIZES)} sizes")
        for n, (g, r, groups) in data.items():
            L = cuda_topk._nblocks(n) * groups * cuda_topk.LANES
            val = torch.empty(L, device="cuda")
            idx = torch.empty(L, dtype=torch.int32, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def floor_call():
                rc = shipped.gtopk_bytes_floor(
                    g.data_ptr(), r.data_ptr(), n, val.data_ptr(),
                    idx.data_ptr(), L, stream)
                if rc != 0:
                    raise RuntimeError(f"gtopk_bytes_floor: CUDA error {rc}")

            print(f"n={n:>10,d} bytes floor (the same bytes, no selection): "
                  f"{device_ms(floor_call):.5f} ms")
            thr = thresholds_for((g + r).abs())
            bound = (8 * n + 8 * L) / HBM_BYTES_PER_S * 1e3
            cells = []
            for name, lib in libs.items():
                _build._lib = lib
                ms = [device_ms(lambda t=t: cuda_topk.fused_stage1_candidates(
                    g, t, r, groups=groups)) for t in (None, thr)]
                cells.append(f"{name}:{ms[0]:.5f}/{ms[1]:.5f}")
            print(f"n={n:>10,d} groups={groups} bound_ms={bound:.5f} "
                  "ms without/with counts: " + " ".join(cells))
    finally:
        _build._lib = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
