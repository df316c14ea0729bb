"""Magnitude top-k selection and sparse-set helpers, in PyTorch.

Counterpart of ``gtopkssgd_tpu/ops/topk.py`` for the selection methods
``exact | blockwise | approx | threshold | pallas | twostage |
simrecall`` and the ``auto`` policy:

* ``topk_abs`` -- exact top-k of |x|; ties go to the lowest index, as
  ``lax.top_k`` orders them (a stable descending sort: ``torch.topk``
  promises no tie order on CUDA).
* ``blockwise_topk_abs`` -- exact in two stages: a batched ``torch.topk``
  over rows of about 65,536, its boundary ties resolved to the lowest
  index, then a reselect over the candidates; bitwise ``topk_abs``.
* ``threshold_topk_abs`` / ``_threshold_tau`` -- 4 rounds of 8-way
  geometric multisection on tau, then a compaction of the survivors and
  one small exact top-k. Method ``pallas`` runs the 4 rounds as one launch
  of the CUDA multisection kernel (``ops.cuda_topk``), method
  ``threshold`` counts each round with ``bucketize_counts``.
* ``twostage_topk_abs`` -- per-bucket max candidates (the CUDA stage-1
  kernel), then an exact reselect over them.
* ``approx`` -- the port's definition of ``lax.approx_max_k`` at recall
  0.95, on every device: the ``twostage`` path (bucket maxima, then an
  exact reselect; expected recall about 0.97 at ``TWOSTAGE_OVERSAMPLE``
  16), the TPU's production behaviour. XLA lowers ``approx_max_k`` to an
  exact top-k on the CPU, so the two are held by recall, not bitwise.
* ``simrecall_topk_abs`` -- the JAX package's deterministic model of a
  0.95-recall selection: the exact top-(k + pad), each of the top k
  dropped with probability 0.05 by a ``uniform`` draw keyed from the
  bits of sum(x) and sum(|x|) (``ops.prng``, threefry as ``jax.random``),
  the freed slots backfilled in rank order.
* ``select_tau`` -- tau alone, for the threshold-mask compressor.
* ``_resolve_auto`` -- ``auto``: ``exact`` up to ``AUTO_SWITCH``
  elements, ``twostage`` above, from the whole selection stage timed on
  an H100 (``select_probe``).
* ``merge_sparse_sets`` -- one round of the gTop-k tree: the sparse sum of
  two sets and their top-k, order-canonical (two stable sorts).

Sparse sets are (values f32[k], indices i32[k]); padding slots carry index
n and value 0. Everything is shape-static and free of host syncs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from gtopkssgd_tpu_torch.ops import cuda_topk, prng
from gtopkssgd_tpu_torch.ops.cuda_topk import BLOCK, BLOCK_ROWS, LANES

#: The JAX CLI's ``--topk-method`` choices, in its order.
METHODS = ("auto", "exact", "blockwise", "approx", "threshold", "pallas",
           "twostage", "simrecall")


def k_for_density(n: int, density: float) -> int:
    """k = max(1, ceil(density * n)) -- the reference's k choice."""
    return max(1, int(math.ceil(float(density) * n)))


def _topk_order(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest entries of `mag`, descending, ties to
    the lowest position."""
    return torch.sort(mag, descending=True, stable=True).indices[:k]


def topk_abs(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of |x|: (signed values, i32 indices), descending."""
    idx = _topk_order(x.abs(), k)
    return x[idx], idx.to(torch.int32)


BLOCKWISE_ROW = 65536
SIMRECALL_KEY = 0x51AEC


def _blockwise_rows(n: int) -> Tuple[int, int]:
    """(rows, row length) of the blockwise split: max(1, n // 65536)
    rows of ceil(n / rows)."""
    rows = max(1, n // BLOCKWISE_ROW)
    return rows, -(-n // rows)


def blockwise_topk_abs(x: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of |x| in two stages: each row of the zero-padded
    (rows, length) view keeps its top min(k, length) by one batched
    ``torch.topk``, the ties at a row's boundary value going to its
    lowest positions; the candidates, in index order, are reselected.
    Every true top-k element is in its row's candidates and ties go to
    the lowest index in both stages, so the result is ``topk_abs``'s,
    bitwise; padding (index >= n) comes back as index n, value 0."""
    n = x.shape[0]
    rows, length = _blockwise_rows(n)
    kb = min(k, length)
    xp = torch.nn.functional.pad(x, (0, rows * length - n))
    mag = xp.abs().view(rows, length)
    kth = torch.topk(mag, kb, dim=1).values[:, -1:]
    above = mag > kth
    tied = mag == kth
    room = kb - above.sum(1, keepdim=True)
    take = above | (tied & (torch.cumsum(tied, 1) <= room))
    # Each row takes exactly kb: compact them in index order.
    slot = torch.cumsum(take, 1) - 1 + torch.arange(
        rows, device=x.device)[:, None] * kb
    slot = torch.where(take, slot, rows * kb)
    pos = torch.arange(rows * length, dtype=torch.int64, device=x.device)
    cand_idx = torch.full((rows * kb + 1,), rows * length, dtype=torch.int64,
                          device=x.device)
    cand_idx.scatter_(0, slot.view(-1), pos)
    cand_idx = cand_idx[:-1]
    cand_val = xp[cand_idx]
    sel = _topk_order(cand_val.abs(), k)
    idx, vals = cand_idx[sel], cand_val[sel]
    oob = idx >= n
    return (torch.where(oob, torch.zeros_like(vals), vals),
            torch.where(oob, torch.full_like(idx, n), idx).to(torch.int32))


def _sum_bits(v: torch.Tensor) -> torch.Tensor:
    """The bits of the float32 sum of `v` as an int32 tensor."""
    return v.sum(dtype=torch.float32).reshape(1).view(torch.int32)[0]


def simrecall_topk_abs(x: torch.Tensor, k: int, recall: float = 0.95
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's pessimistic model of a `recall` selection: the
    exact top-m, m = min(n, k + pad), pad = max(16, ceil(4k(1 -
    recall))); each of the top k dropped where a uniform draw exceeds
    `recall`; survivors in rank order, then the backfill ranks k..m, then
    the dropped ones. The draw's key is ``PRNGKey(0x51AEC)`` folded with
    the bits of sum(x), then of sum(|x|), both float32, so it follows
    the data. A float32 sum depends on its order, and torch's (and the
    card's) is not XLA's: the set is bitwise JAX's only where the sums
    are exact in any order."""
    n = x.shape[0]
    pad = max(16, int(math.ceil(k * (1.0 - recall) * 4)))
    m = min(n, k + pad)
    vals, idx = topk_abs(x, m)
    key = prng.fold_in(prng.prng_key(SIMRECALL_KEY, x.device), _sum_bits(x))
    key = prng.fold_in(key, _sum_bits(x.abs()))
    ranks = torch.arange(m, dtype=torch.int64, device=x.device)
    draw = prng.uniform(key, m)
    # JAX compares in float32: the float32 `recall`, exactly.
    dropped = (ranks < k) & (draw > float(np.float32(recall)))
    order = torch.sort(torch.where(dropped, m + ranks, ranks)).indices[:k]
    return vals[order], idx[order]


def bucketize_counts(mag: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """counts[i] = #{j : mag[j] >= thr[i]} in one logical pass: bucketize
    every magnitude against the sorted thresholds, histogram the bucket
    ids, and read each count as a suffix sum."""
    nthr = thr.shape[0]
    ts, order = torch.sort(thr)
    bucket = torch.searchsorted(ts, mag, right=True)  # #{ts <= mag_j}
    # An integer scatter of ones: bincount would read the largest id back
    # to the host to size its output, a sync in the selection.
    hist = torch.zeros(nthr + 1, dtype=torch.int64, device=mag.device)
    hist.index_add_(0, bucket, torch.ones_like(bucket))
    ge = hist.flip(0).cumsum(0).flip(0)  # ge[i] = #{bucket >= i}
    counts = torch.empty(nthr, dtype=torch.int32, device=mag.device)
    counts[order] = ge[1:].to(torch.int32)
    return counts


def _tau_lo(x: torch.Tensor, mag: torch.Tensor, k: int, pallas: bool,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """lo of the tau bracket over mag = |x (+ residual)|, after 4 rounds of
    8-way geometric multisection (count(mag >= lo) >= k always holds):
    under `pallas` the multisection kernel reads x (+ residual) in one
    launch; otherwise the same rounds count `mag` with bucketize_counts."""
    if pallas:
        return cuda_topk.multisection_tau_lo(x, k, residual)[0]
    return cuda_topk.multisection_rounds(mag, k, bucketize_counts)[0]


def _compact(selected: torch.Tensor, src: torch.Tensor, cap: int,
             fill) -> torch.Tensor:
    """The first `cap` entries of `src` where `selected`, in index order,
    padded with `fill` (the JAX cumsum + scatter mode='drop')."""
    pos = torch.cumsum(selected, 0, dtype=torch.int64) - 1
    slot = torch.where(selected & (pos < cap), pos, cap)
    buf = torch.full((cap + 1,), fill, dtype=src.dtype, device=src.device)
    buf.scatter_(0, slot, src)  # slot cap collects the dropped entries
    return buf[:cap]


def threshold_topk_abs(x: torch.Tensor, k: int, *, pallas: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of |x| by threshold multisection + compaction: exact whenever
    the survivors fit in cap = min(n, max(2k, k + 4096)); beyond that the
    lowest indices among the boundary values win. `pallas` finds the
    bracket with the multisection kernel."""
    n = x.shape[0]
    if k >= n:
        return topk_abs(x, k)
    mag = x.abs()
    tau = _tau_lo(x, mag, k, pallas)
    cap = min(n, max(2 * k, k + 4096))
    selected = mag >= tau
    buf_v = _compact(selected, x, cap, 0.0)
    buf_i = _compact(selected, torch.arange(n, dtype=torch.int32,
                                            device=x.device), cap, n)
    sel = _topk_order(buf_v.abs(), k)
    return buf_v[sel], buf_i[sel]


def _threshold_tau(x: torch.Tensor, k: int,
                   residual: Optional[torch.Tensor] = None, *,
                   pallas: bool = False) -> torch.Tensor:
    """tau of the threshold family over acc = x (+ residual) without an
    index set: the same bracket as threshold_topk_abs, then the k-th
    largest compacted magnitude."""
    n = x.shape[0]
    acc = x if residual is None else x + residual
    mag = acc.abs()
    if k >= n:
        return mag.min()
    lo = _tau_lo(x, mag, k, pallas, residual)
    cap = min(n, max(2 * k, k + 4096))
    buf_m = _compact(mag >= lo, mag, cap, 0.0)
    return torch.topk(buf_m, k).values[k - 1]


# Stage-1 bucket count target: L ~= TWOSTAGE_OVERSAMPLE * k buckets, so the
# expected recall of top-1-per-bucket selection is ~1 - (k-1)/(2L).
TWOSTAGE_OVERSAMPLE = 16


def _twostage_pallas_groups(n: int, k: int) -> int:
    """Row-groups per 2048x128 tile: the power of two that keeps the bucket
    size rpg = 2048/groups <= n/(TWOSTAGE_OVERSAMPLE*k), and at least k
    buckets."""
    nblocks = max(1, -(-n // BLOCK))
    target_rpg = max(1, n // max(1, TWOSTAGE_OVERSAMPLE * k))
    g = 1
    while BLOCK_ROWS // g > target_rpg and g < BLOCK_ROWS:
        g *= 2
    while nblocks * g * LANES < k and g < BLOCK_ROWS:
        g *= 2
    return g


def _twostage_candidates(
    x: torch.Tensor,
    k: int,
    *,
    residual: Optional[torch.Tensor] = None,
    layout: str = "tile",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1: per-bucket max-|acc| candidates (cand_val f32[L], cand_idx
    i32[L]) with acc = x (+ residual); indices >= n mark padding buckets.
    ``layout="tile"`` is the kernel's (row-group, lane) tile layout, the
    one the port runs; ``layout="stride"`` is the plain stride-L layout
    the JAX package runs off the TPU, for like-with-like tests."""
    n = x.shape[0]
    if layout == "tile":
        groups = _twostage_pallas_groups(n, k)
        cand_val, cand_idx, _ = cuda_topk.fused_stage1_candidates(
            x, residual=residual, groups=groups)
        return cand_val, cand_idx
    if layout == "stride":
        return cuda_topk.stride_candidates_ref(
            x, max(k, min(n, TWOSTAGE_OVERSAMPLE * k)), residual)
    raise ValueError(f"unknown stage-1 layout {layout!r}")


def twostage_topk_abs(
    x: torch.Tensor,
    k: int,
    *,
    residual: Optional[torch.Tensor] = None,
    layout: str = "tile",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage approximate top-k of |x (+ residual)|: one stage-1 pass
    keeps each bucket's max, then an exact reselect of k candidates.
    A true top-k element is missed only when a larger one shares its
    bucket; error feedback keeps the misses in the residual."""
    n = x.shape[0]
    if k >= n:
        acc = x if residual is None else x + residual
        vals, idx = topk_abs(acc, n)
        if k > n:
            vals = torch.nn.functional.pad(vals, (0, k - n))
            idx = torch.nn.functional.pad(idx, (0, k - n), value=n)
        return vals, idx
    cand_val, cand_idx = _twostage_candidates(
        x, k, residual=residual, layout=layout)
    sel = _topk_order(cand_val.abs(), k)
    idx, vals = cand_idx[sel], cand_val[sel]
    oob = idx >= n
    return (torch.where(oob, torch.zeros_like(vals), vals),
            torch.where(oob, torch.full_like(idx, n), idx))


# The largest size at which ``exact`` (a full stable sort) took no longer
# than ``twostage`` with ``twostage`` faster at every size above, for the
# whole selection stage on an NVIDIA H100 80GB HBM3 at 700.00 W
# (``select_probe --flat``, ``parallel/select_auto.json``): 0.2630 against
# 0.3027 ms at 2^21; 0.4043 against 0.2595 at 2^22, 3.9640 against 0.8228
# at 61.1M. Below it both sit near the launch floor.
AUTO_SWITCH = 1 << 21


def _resolve_auto(n: int) -> str:
    """The `auto` policy: ``exact`` up to ``AUTO_SWITCH`` elements,
    ``twostage`` above."""
    return "exact" if n <= AUTO_SWITCH else "twostage"


def _method(method: str, n: int) -> str:
    """`method` with ``auto`` resolved at size n and ``approx`` read as
    ``twostage`` (its definition in the port); refuses unknown names."""
    if method not in METHODS:
        raise ValueError(f"unknown topk method {method!r}")
    if method == "auto":
        method = _resolve_auto(n)
    return "twostage" if method == "approx" else method


def select_tau(
    x: torch.Tensor,
    k: int,
    method: str = "auto",
    *,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The selection threshold tau (the smallest magnitude the method would
    select) over acc = x (+ residual), without building a (vals, idx) set.
    For twostage, tau is the k-th largest CANDIDATE magnitude, so the mask
    |acc| >= tau holds every candidate the reselect would keep."""
    n = x.shape[0]
    method = _method(method, n)
    if method == "twostage":
        if k >= n:
            acc = x if residual is None else x + residual
            return acc.abs().min()
        cand_val, _ = _twostage_candidates(x, k, residual=residual)
        return torch.topk(cand_val.abs(), k).values[k - 1]
    if method in ("threshold", "pallas"):
        return _threshold_tau(x, k, residual, pallas=method == "pallas")
    acc = x if residual is None else x + residual
    if k >= n:
        return acc.abs().min()
    if method == "blockwise":
        rows, length = _blockwise_rows(n)
        mag = torch.nn.functional.pad(acc.abs(), (0, rows * length - n))
        cand = torch.topk(mag.view(rows, length), min(k, length), dim=1)
        return torch.topk(cand.values.reshape(-1), k).values[k - 1]
    if method == "simrecall":
        return simrecall_topk_abs(acc, k)[0].abs().min()
    return torch.topk(acc.abs(), k).values[k - 1]


def select_topk(
    x: torch.Tensor,
    k: int,
    method: str = "auto",
    *,
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, idx) of the top-k of |x (+ residual)| by the chosen method;
    values are read from acc. `twostage` (and `approx`, the same path)
    folds the add into its stage-1 pass; the other methods add first."""
    method = _method(method, x.shape[0])
    if method == "twostage":
        return twostage_topk_abs(x, k, residual=residual)
    if residual is not None:
        x = x + residual
    if method == "exact":
        return topk_abs(x, k)
    if method == "blockwise":
        return blockwise_topk_abs(x, k)
    if method == "simrecall":
        return simrecall_topk_abs(x, k)
    return threshold_topk_abs(x, k, pallas=method == "pallas")


def merge_sparse_sets(vals_a: torch.Tensor, idx_a: torch.Tensor,
                      vals_b: torch.Tensor, idx_b: torch.Tensor, k: int,
                      n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round of the gTop-k tree: sparse-sum two sets, each with unique
    real indices, and keep the top-k by magnitude, descending.

    Order-canonical, so both partners of an exchange get bitwise the same
    set whichever of them is `a`: a stable sort by index makes duplicates
    adjacent (a real index occurs at most twice); the pair is summed into
    its first slot (a + b == b + a in IEEE arithmetic) and the second slot
    becomes the sentinel (index n, value 0); a stable sort on -|value|
    then breaks magnitude ties by the lower index, as ``lax.top_k`` does.
    """
    cat_idx = torch.cat([idx_a, idx_b])
    cat_val = torch.cat([vals_a, vals_b])
    si, order = torch.sort(cat_idx, stable=True)
    sv = cat_val[order]
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[1:] = si[1:] == si[:-1]
    next_dup = torch.zeros_like(dup)
    next_dup[:-1] = dup[1:]
    summed = sv + torch.where(next_dup, torch.roll(sv, -1), 0.0)
    merged_val = torch.where(dup, 0.0, summed)
    merged_idx = torch.where(dup, n, si).to(torch.int32)
    keep = torch.sort(-merged_val.abs(), stable=True).indices[:k]
    return merged_val[keep], merged_idx[keep]


def scatter_add_dense(n: int, idx: torch.Tensor, vals: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """zeros(n) with vals added at idx; indices >= n (padding) drop out."""
    out = torch.zeros(n + 1, dtype=dtype, device=vals.device)
    out.index_add_(0, idx.clamp(max=n).long(), vals.to(dtype))
    return out[:n]


def membership_mask(query_idx: torch.Tensor,
                    set_idx: torch.Tensor) -> torch.Tensor:
    """bool[len(query_idx)]: is each query index present in `set_idx`?"""
    sorted_set = torch.sort(set_idx).values
    pos = torch.searchsorted(sorted_set, query_idx)
    pos = pos.clamp(0, set_idx.shape[0] - 1)
    return sorted_set[pos] == query_idx
