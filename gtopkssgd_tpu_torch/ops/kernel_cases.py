"""Inputs and checks that hold the hand-written kernels to their plain
twins, bitwise (NaNs compared as bits).

``edge_cases`` (with ``tie_input`` and ``nan_cases``) are the stage-1
kernel's edge cases: every n in EDGE_SIZES at every groups in EDGE_GROUPS,
views one float into their buffers, equal maxima of opposite signs in rows
that different warps read, and NaNs; ``stage1_mismatch`` compares the
kernel's candidates and counts with its twin's on one of them.
``apply_cases`` (labels APPLY_CASES, special values from ``apply_input``)
are the threshold apply's, compared by ``apply_mismatch``. ``same_bits``
compares two tensors bit for bit.

The CPU tests build these cases on the CPU, where the wrappers run the
twins; the card tests and ``chip_smoke.py`` build them on the card and
compare kernel against twin. The package itself does not import this module.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from gtopkssgd_tpu_torch.ops import cuda_topk

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


def apply_input(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(grad, residual) f32[n], normal draws with the special values of the
    threshold apply at the front: NaN in either operand, +-inf, inf + -inf,
    -0.0 + -0.0, 0.0 + -0.0, a value that cancels to +0.0, a residual
    that cancels the gradient, and an inf that a finite residual cannot
    move. n >= 16."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    r = (0.3 * rng.standard_normal(n)).astype(np.float32)
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    specials = ((nan, 0.5), (0.5, nan), (nan, nan), (inf, 0.0), (-inf, 1.0),
                (inf, -inf), (-0.0, -0.0), (0.0, -0.0), (-0.0, 0.0),
                (2.5, -2.5), (-3.0, 0.0), (inf, 2.0), (-inf, -inf),
                (np.copysign(nan, np.float32(-1.0)), 0.25), (1e-38, 0.0),
                (0.0, 0.0))
    for i, (a, b) in enumerate(specials):
        g[i], r[i] = a, b
    return g, r


# The labels of ``apply_cases``, in order.
APPLY_CASES = ("n=272474", "n=262147 unaligned x[1:]", "n=1", "n=3", "n=6",
               "no residual n=262146", "nan inf -0", "nan inf -0 x[1:]",
               "tau 0", "ties", "all zero", "tau inf", "tau nan", "all nan")


def apply_cases(device: torch.device | str, seed: int = 0
                ) -> Iterator[Tuple[str, torch.Tensor,
                                    Optional[torch.Tensor], torch.Tensor]]:
    """(label, src, res_in, tau) on `device`, one for each of APPLY_CASES:
    sizes with every remainder mod 4 and views one float into their
    buffers; tau equal to a datum's magnitude (ties at tau), 0 (with exact
    zeros and -0.0), +inf and NaN; no residual; NaNs, infinities and signed
    zeros in both operands (``apply_input``)."""
    rng = np.random.default_rng(seed)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def tau(v: float) -> torch.Tensor:
        return dev(np.array(v, np.float32))

    def normal(n: int):
        return (rng.standard_normal(n).astype(np.float32),
                (0.3 * rng.standard_normal(n)).astype(np.float32))

    g, r = normal(272_474)
    yield "n=272474", dev(g), dev(r), tau(abs(g[7] + r[7]))
    g, r = normal(262_148)
    yield ("n=262147 unaligned x[1:]", dev(g)[1:], dev(r)[1:],
           tau(abs(g[100] + r[100])))
    for n in (1, 3, 6):
        g, r = normal(n)
        yield f"n={n}", dev(g), dev(r), tau(abs(g[0] + r[0]))
    g, _ = normal(262_146)
    yield "no residual n=262146", dev(g), None, tau(abs(g[5]))
    g, r = apply_input(272_474, seed)
    yield "nan inf -0", dev(g), dev(r), tau(1.5)
    g, r = apply_input(262_147, seed + 1)
    yield "nan inf -0 x[1:]", dev(g)[1:], dev(r)[1:], tau(1.5)
    g, r = apply_input(100_003, seed + 2)
    g[rng.random(g.shape[0]) < 0.3] = 0.0
    r[g == 0.0] = rng.choice(np.array([0.0, -0.0], np.float32),
                             int((g == 0.0).sum()))
    yield "tau 0", dev(g), dev(r), tau(0.0)
    g, r = tie_input(262_144, 8, seed)
    yield "ties", dev(g), dev(r), tau(2.0)
    z = np.zeros(100_001, np.float32)
    z[1::2] = -0.0
    yield "all zero", dev(z), dev(z.copy()), tau(0.0)
    g, r = apply_input(50_000, seed + 3)
    yield "tau inf", dev(g), dev(r), tau(np.inf)
    yield "tau nan", dev(g), dev(r), tau(np.nan)
    yield ("all nan", dev(np.full(1000, np.nan, np.float32)),
           dev(normal(1000)[1]), tau(0.5))


def apply_mismatch(src: torch.Tensor, res_in: Optional[torch.Tensor],
                   tau: torch.Tensor) -> Optional[str]:
    """None when ``threshold_apply`` gives its twin's five outputs bitwise
    (NaNs as bits), with acc asked for and not; else what differs."""
    names = ("keep", "residual", "update", "kept_tau", "acc")
    for want_acc in (True, False):
        got = cuda_topk.threshold_apply(src, res_in, tau, want_acc)
        want = cuda_topk.threshold_apply_ref(src, res_in, tau, want_acc)
        for name, a, b in zip(names, got, want):
            if (a is None) != (b is None):
                return f"{name} (want_acc {want_acc}): one side is None"
            if a is not None and not same_bits(a, b):
                at = (bits(a) != bits(b)).reshape(-1).nonzero()[:4]
                at = at.flatten().tolist()
                return (f"{name} differs (want_acc {want_acc}) at {at}: "
                        f"{a.reshape(-1)[at].tolist()} vs twin "
                        f"{b.reshape(-1)[at].tolist()}")
    return None


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
