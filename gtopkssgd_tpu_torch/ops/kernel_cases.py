"""Inputs and checks that hold the hand-written kernels to their plain
twins, bitwise (NaNs compared as bits).

``edge_cases`` (with ``tie_input`` and ``nan_cases``) are the stage-1
kernel's edge cases: every n in EDGE_SIZES at every groups in EDGE_GROUPS,
views one float into their buffers, equal maxima of opposite signs in rows
that different warps read, and NaNs; ``stage1_mismatch`` compares the
kernel's candidates and counts with its twin's on one of them.
``apply_cases`` (labels APPLY_CASES, special values from ``apply_input``)
are the threshold apply's, compared by ``apply_mismatch``. ``sgd_cases``
(a layout of every leaf kind, ``SGD_EDGE_LEAVES``, under every
``SGD_HYPERS`` and buffer state) and ``sgd_case`` at a model's layout
(``model_leaves``) are the SGD apply's, compared by ``sgd_mismatch`` with
the path it replaced (``sgd_parent``). ``same_bits`` compares two tensors
bit for bit.

The CPU tests build these cases on the CPU, where the wrappers run the
twins; the card tests and ``chip_smoke.py`` build them on the card and
compare kernel against twin. The package itself does not import this module.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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


# (shape, perm) of each leaf of the SGD apply's edge layout, in flat order:
# an aligned identity leaf of two items, a convolution of 11 x 11 windows,
# ragged tiles, a 1 x 1 convolution, dense weights, 1-element leaves and
# odd sizes that move the later offsets off multiples of 4, an embedding,
# a permutation that merges into a transpose and two that stay strided.
SGD_EDGE_LEAVES = (
    ((8200,), (0,)), ((64, 3, 11, 11), (2, 3, 1, 0)),
    ((37, 5, 3, 3), (2, 3, 1, 0)), ((3,), (0,)),
    ((48, 33, 1, 1), (2, 3, 1, 0)), ((70, 45), (1, 0)), ((1, 1), (1, 0)),
    ((1,), (0,)), ((4099,), (0,)), ((11, 830), (0, 1)),
    ((6, 4, 5), (2, 0, 1)), ((5, 6, 7), (1, 0, 2)), ((3, 4, 5), (0, 2, 1)),
    ((33, 64), (1, 0)),
)
# SGD's hyperparameters as the port sets them: momentum with and without
# weight decay and Nesterov, and momentum 0 (momentum correction).
SGD_HYPERS = (
    dict(lr=0.1, momentum=0.9, weight_decay=1e-4, nesterov=False),
    dict(lr=0.0123, momentum=0.9, weight_decay=0.0, nesterov=False),
    dict(lr=0.05, momentum=0.9, weight_decay=5e-4, nesterov=True),
    dict(lr=0.1, momentum=0.9, weight_decay=0.0, nesterov=True),
    dict(lr=0.1, momentum=0.0, weight_decay=1e-4, nesterov=False),
    dict(lr=0.01, momentum=0.0, weight_decay=0.0, nesterov=False),
)
# Momentum buffers before the step: all there, none (the first step), or
# every third leaf's missing (a snapshot's restore dropped them).
SGD_BUFFERS = ("all", "none", "some")


def model_leaves(dnn: str, config: Optional[dict] = None
                 ) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """(shape, perm) of each leaf of `dnn`'s flat layout (the model built on
    the meta device; a language model from `config`)."""
    from gtopkssgd_tpu_torch.convert import flat_layout
    from gtopkssgd_tpu_torch.models import get_model

    with torch.device("meta"):
        model, _ = get_model(dnn, config=config)
    lay = flat_layout(model)
    return [(tuple(p.shape), perm) for p, perm in zip(lay.params, lay.perms)]


def sgd_case(leaves: Sequence[Tuple[Sequence[int], Sequence[int]]],
             device: torch.device | str, seed: int = 0,
             buffers: str = "all", specials: bool = False) -> Dict:
    """Inputs of the SGD apply over the layout `leaves`: {"update",
    "params", "perms", "bufs"}, normal draws made on `device`; `buffers`
    one of SGD_BUFFERS; with `specials`, NaN, -NaN, +-inf, +-0.0 and a
    subnormal at the front of each leaf's update, parameter and buffer."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale):
        return scale * torch.randn(shape, device=device, generator=gen)

    params = [draw(shape, 0.05) for shape, _ in leaves]
    n = sum(p.numel() for p in params)
    update = draw((n,), 0.01)
    bufs = [draw(p.shape, 0.02) if buffers == "all"
            or (buffers == "some" and i % 3) else None
            for i, p in enumerate(params)]
    if specials:
        vals = torch.tensor([np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0,
                             1e-40], dtype=torch.float32, device=device)
        off = 0
        for i, p in enumerate(params):
            m = min(p.numel(), vals.numel())
            k = (i % vals.numel())  # another special in each leaf's first
            rolled = torch.roll(vals, k)[:m]
            update[off:off + m] = rolled
            p.view(-1)[:m] = torch.roll(vals, k + 2)[:m]
            if bufs[i] is not None:
                bufs[i].view(-1)[:m] = torch.roll(vals, k + 4)[:m]
            off += p.numel()
    return {"update": update, "params": params,
            "perms": [tuple(perm) for _, perm in leaves], "bufs": bufs}


def sgd_case_specs() -> List[Tuple[str, int, str, bool]]:
    """(label, index into SGD_HYPERS, buffers, specials) of each of
    ``sgd_cases``: every SGD_HYPERS under every SGD_BUFFERS (momentum 0
    has no buffers), with and without special values."""
    return [(f"{hyper} buffers {buffers}{' specials' if specials else ''}",
             h, buffers, specials)
            for h, hyper in enumerate(SGD_HYPERS)
            for buffers in (SGD_BUFFERS if hyper["momentum"] else ("all",))
            for specials in (False, True)]


def sgd_cases(device: torch.device | str, seed: int = 0,
              specs: Optional[Sequence] = None
              ) -> Iterator[Tuple[str, Dict, Dict]]:
    """(label, case, hyper) over the edge layout for each of `specs`
    (default: every ``sgd_case_specs``)."""
    for label, h, buffers, specials in specs or sgd_case_specs():
        yield (label, sgd_case(SGD_EDGE_LEAVES, device, seed + h, buffers,
                               specials), SGD_HYPERS[h])


def flat_offsets(params: Sequence[torch.Tensor]) -> List[int]:
    """Each tensor's offset in a flat vector that holds them back to
    back."""
    out, off = [], 0
    for p in params:
        out.append(off)
        off += p.numel()
    return out


def sgd_parent(case: Dict, hyper: Dict
               ) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
    """The path the SGD apply replaced, on copies of the case's tensors:
    the update copied into each parameter's ``.grad`` (``FlatLayout.
    unravel_into``), then one ``torch.optim.SGD`` step (its foreach step
    on a CUDA device). Returns the parameters and momentum buffers."""
    from gtopkssgd_tpu_torch.optimizer import FlatLayout

    params = [torch.nn.Parameter(p.detach().clone()) for p in case["params"]]
    lay = FlatLayout(list(zip(params, case["perms"])))
    for p in params:
        p.grad = torch.empty_like(p)
    lay.unravel_into(case["update"], [p.grad for p in params])
    opt = torch.optim.SGD(params, **hyper)
    if hyper["momentum"]:
        for p, b in zip(params, case["bufs"]):
            if b is not None:
                opt.state[p]["momentum_buffer"] = b.clone()
    opt.step()
    return ([p.detach() for p in params],
            [opt.state[p].get("momentum_buffer") for p in params])


def sgd_run(case: Dict, hyper: Dict):
    """``cuda_topk.sgd_apply`` (the kernel on a CUDA device, the twin on
    the CPU) on copies of the case's tensors; returns the parameters and
    momentum buffers."""
    params = [p.clone() for p in case["params"]]
    leaves = cuda_topk.SgdLeaves(params, case["perms"], flat_offsets(params))
    bufs = ([None if b is None else b.clone() for b in case["bufs"]]
            if hyper["momentum"] else None)
    bufs = cuda_topk.sgd_apply(case["update"], leaves, bufs, **hyper)
    return params, (bufs if bufs is not None else [None] * len(params))


def sgd_mismatch(case: Dict, hyper: Dict) -> Optional[str]:
    """None when the SGD apply gives the parameters and momentum buffers
    of ``sgd_parent`` bitwise (NaNs as bits); else what differs."""
    got = sgd_run(case, hyper)
    want = sgd_parent(case, hyper)
    for name, gs, ws in zip(("param", "momentum buffer"), got, want):
        for i, (a, b) in enumerate(zip(gs, ws)):
            if (a is None) != (b is None):
                return f"{name} {i}: one side is None"
            if a is not None and not same_bits(a, b):
                at = (bits(a) != bits(b)).reshape(-1).nonzero()[:4]
                at = at.flatten().tolist()
                return (f"{name} {i} {tuple(a.shape)} differs at {at}: "
                        f"{a.reshape(-1)[at].tolist()} vs the parent path's "
                        f"{b.reshape(-1)[at].tolist()}")
    return None
