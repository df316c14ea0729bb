"""Magnitude top-k selection and sparse-set helpers, in PyTorch.

Counterpart of ``gtopkssgd_tpu/ops/topk.py`` for the selection methods
``exact | threshold | pallas | twostage``:

* ``topk_abs`` -- exact top-k of |x|; ties go to the lowest index, as
  ``lax.top_k`` orders them (a stable descending sort: ``torch.topk``
  promises no tie order on CUDA).
* ``threshold_topk_abs`` / ``_threshold_tau`` -- 4 rounds of 8-way
  geometric multisection on tau, then a compaction of the survivors and
  one small exact top-k. Method ``pallas`` counts with the CUDA count
  kernel (``ops.cuda_topk``), method ``threshold`` with ``bucketize_counts``.
* ``twostage_topk_abs`` -- per-bucket max candidates (the CUDA stage-1
  kernel), then an exact reselect over them.
* ``select_tau`` -- tau alone, for the threshold-mask compressor.
* ``merge_sparse_sets`` -- one round of the gTop-k tree: the sparse sum of
  two sets and their top-k, order-canonical (two stable sorts).

Sparse sets are (values f32[k], indices i32[k]); padding slots carry index
n and value 0. Everything is shape-static and free of host syncs.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from gtopkssgd_tpu_torch.ops import cuda_topk
from gtopkssgd_tpu_torch.ops.cuda_topk import BLOCK, BLOCK_ROWS, LANES

CountFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
METHODS = ("auto", "exact", "threshold", "pallas", "twostage")


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


def bucketize_counts(mag: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """counts[i] = #{j : mag[j] >= thr[i]} in one logical pass: bucketize
    every magnitude against the sorted thresholds, histogram the bucket
    ids, and read each count as a suffix sum."""
    nthr = thr.shape[0]
    ts, order = torch.sort(thr)
    bucket = torch.searchsorted(ts, mag, right=True)  # #{ts <= mag_j}
    hist = torch.bincount(bucket, minlength=nthr + 1)
    ge = hist.flip(0).cumsum(0).flip(0)  # ge[i] = #{bucket >= i}
    counts = torch.empty(nthr, dtype=torch.int32, device=mag.device)
    counts[order] = ge[1:].to(torch.int32)
    return counts


def _multisection_tau_lo(mag: torch.Tensor, k: int,
                         count_fn: CountFn) -> torch.Tensor:
    """The lower end of the tau bracket after 4 rounds of 8-way geometric
    multisection: count(mag >= lo) >= k always holds."""
    maxv = mag.max()
    lo = torch.zeros((), dtype=mag.dtype, device=mag.device)
    hi = maxv
    powers = torch.arange(1, 9, dtype=mag.dtype, device=mag.device)
    for _ in range(4):
        lo_eff = torch.maximum(lo, maxv * 1e-12 + 1e-30)
        r = (lo_eff / (hi + 1e-30)) ** (1.0 / 9.0)
        thr = hi * r ** powers  # 8 candidates strictly inside (lo, hi)
        ge = count_fn(mag, thr) >= k
        lo = torch.maximum(lo, torch.where(ge, thr, lo).max())
        hi = torch.minimum(hi, torch.where(ge, hi, thr).min())
    return lo


def _compact(selected: torch.Tensor, src: torch.Tensor, cap: int,
             fill) -> torch.Tensor:
    """The first `cap` entries of `src` where `selected`, in index order,
    padded with `fill` (the JAX cumsum + scatter mode='drop')."""
    pos = torch.cumsum(selected, 0, dtype=torch.int64) - 1
    slot = torch.where(selected & (pos < cap), pos, cap)
    buf = torch.full((cap + 1,), fill, dtype=src.dtype, device=src.device)
    buf.scatter_(0, slot, src)  # slot cap collects the dropped entries
    return buf[:cap]


def threshold_topk_abs(x: torch.Tensor, k: int,
                       count_fn: Optional[CountFn] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of |x| by threshold multisection + compaction: exact whenever
    the survivors fit in cap = min(n, max(2k, k + 4096)); beyond that the
    lowest indices among the boundary values win."""
    n = x.shape[0]
    if k >= n:
        return topk_abs(x, k)
    mag = x.abs()
    tau = _multisection_tau_lo(mag, k, count_fn or bucketize_counts)
    cap = min(n, max(2 * k, k + 4096))
    selected = mag >= tau
    buf_v = _compact(selected, x, cap, 0.0)
    buf_i = _compact(selected, torch.arange(n, dtype=torch.int32,
                                            device=x.device), cap, n)
    sel = _topk_order(buf_v.abs(), k)
    return buf_v[sel], buf_i[sel]


def _threshold_tau(x: torch.Tensor, k: int,
                   count_fn: Optional[CountFn] = None) -> torch.Tensor:
    """tau of the threshold family without an index set: the same bracket
    as threshold_topk_abs, then the k-th largest compacted magnitude."""
    n = x.shape[0]
    mag = x.abs()
    if k >= n:
        return mag.min()
    lo = _multisection_tau_lo(mag, k, count_fn or bucketize_counts)
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


def _resolve_auto(n: int) -> str:
    """The `auto` policy. Exact for now at every size: the JAX package's
    choice above 2^20 elements was measured on a TPU and does not carry
    over; the H100 policy waits for H100 measurements."""
    return "exact"


def _pallas_count_fn(x: torch.Tensor,
                     residual: Optional[torch.Tensor]) -> CountFn:
    """Count rounds that read x (+ residual) through the fused count
    kernel instead of the materialized magnitudes."""
    return lambda _mag, thr: cuda_topk.fused_multi_threshold_count(
        x, thr, residual)


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
    if method == "auto":
        method = _resolve_auto(n)
    if method not in METHODS:
        raise ValueError(f"unknown topk method {method!r}")
    if method == "twostage":
        if k >= n:
            acc = x if residual is None else x + residual
            return acc.abs().min()
        cand_val, _ = _twostage_candidates(x, k, residual=residual)
        return torch.topk(cand_val.abs(), k).values[k - 1]
    acc = x if residual is None else x + residual
    if k >= n:
        return acc.abs().min()
    if method == "exact":
        return torch.topk(acc.abs(), k).values[k - 1]
    if method == "threshold":
        return _threshold_tau(acc, k)
    return _threshold_tau(acc, k, count_fn=_pallas_count_fn(x, residual))


def select_topk(
    x: torch.Tensor,
    k: int,
    method: str = "auto",
    *,
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, idx) of the top-k of |x (+ residual)| by the chosen method;
    values are read from acc. `twostage` folds the add into its stage-1
    pass; the other methods add first."""
    if method == "auto":
        method = _resolve_auto(x.shape[0])
    if method not in METHODS:
        raise ValueError(f"unknown topk method {method!r}")
    if method == "twostage":
        return twostage_topk_abs(x, k, residual=residual)
    if residual is not None:
        x = x + residual
    if method == "exact":
        return topk_abs(x, k)
    if method == "threshold":
        return threshold_topk_abs(x, k)
    return threshold_topk_abs(x, k, count_fn=cuda_topk.multi_threshold_count)


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
