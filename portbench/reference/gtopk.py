"""The gTop-k step with error feedback over P workers, and SGD.

Per worker r, with the flat float32 gradient g_r and its residual e_r:

* acc_r = g_r + e_r;
* the two-stage selection (arXiv:1901.04359's top-k, as the port
  configures it above 2^21 elements): the flat vector is cut into tiles of
  2048 x 128 elements; each tile's rows are cut into ``groups`` row groups
  of rpg = 2048 / groups rows, and a bucket is one (tile, group, lane): the
  rpg elements ``tile * 262144 + (group * rpg + row) * 128 + lane``. Each
  bucket offers its largest |acc| (the first, on a tie); the k largest
  offers are selected. ``groups`` is the power of two that keeps a bucket
  at most n / (16 k) elements and gives at least k buckets;
* P = 1: tau is the k-th largest offer; every element with |acc| >= tau
  (and |acc| > 0) is kept, e = acc where not kept, and the update is acc
  where kept;
* P > 1: worker r's local set is its k selected (index, value) pairs,
  e_r = acc_r with its picks zeroed; the sets merge over log2(P) rounds
  of a hypercube (round i pairs worker a with a XOR 2^i): both partners
  sum the two sets and keep the k largest |sums|, ties to the lower
  index; every worker ends with one global set G. A local pick that is
  not in G goes back into e_r. The update is the dense sum of G over P;
* SGD: d = update + wd * p; the velocity is d at the first step, then
  momentum * velocity + d; p -= lr * velocity.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

BLOCK_ROWS, LANES = 2048, 128
BLOCK = BLOCK_ROWS * LANES
OVERSAMPLE = 16


def groups(n: int, k: int) -> int:
    nblocks = max(1, -(-n // BLOCK))
    target = max(1, n // max(1, OVERSAMPLE * k))
    g = 1
    while BLOCK_ROWS // g > target and g < BLOCK_ROWS:
        g *= 2
    while nblocks * g * LANES < k and g < BLOCK_ROWS:
        g *= 2
    return g


def offers(acc: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, index) of each bucket's first largest |acc|, in bucket
    order (tile, group, lane); a bucket past the end offers index n and
    value 0."""
    n = acc.shape[0]
    g = groups(n, k)
    nb, rpg = max(1, -(-n // BLOCK)), BLOCK_ROWS // g
    pad = nb * BLOCK - n
    a = torch.cat([acc, acc.new_zeros(pad)])
    mag = torch.cat([acc.abs(), acc.new_full((pad,), -1.0)])
    mag4 = mag.view(nb, g, rpg, LANES)
    top = mag4.max(dim=2, keepdim=True).values
    rows = torch.arange(rpg, device=acc.device).view(1, 1, rpg, 1)
    first = torch.where(mag4 == top, rows, rpg).amin(dim=2)
    tile = torch.arange(nb, device=acc.device).view(nb, 1, 1)
    grp = torch.arange(g, device=acc.device).view(1, g, 1)
    lane = torch.arange(LANES, device=acc.device).view(1, 1, LANES)
    idx = (tile * BLOCK + (grp * rpg + first) * LANES + lane).reshape(-1)
    val = a[idx]
    idx = torch.where(idx < n, idx, torch.full_like(idx, n))
    return torch.where(idx < n, val, torch.zeros_like(val)), idx


def _k_largest(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest of `mag`, ties to the lower position."""
    order = torch.sort(mag, descending=True, stable=True).indices
    return order[:k]


def threshold_keep(acc: torch.Tensor, k: int) -> torch.Tensor:
    """P = 1: the kept mask, |acc| >= tau and |acc| > 0."""
    val, _ = offers(acc, k)
    tau = torch.topk(val.abs(), k).values[k - 1]
    mag = acc.abs()
    return (mag >= tau) & (mag > 0)


def local_set(acc: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """P > 1: the k selected (values, indices); padding index n."""
    val, idx = offers(acc, k)
    sel = _k_largest(val.abs(), k)
    return val[sel], idx[sel]


def merge(a: Tuple[torch.Tensor, torch.Tensor],
          b: Tuple[torch.Tensor, torch.Tensor], k: int, n: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest |sums| of two sparse sets, ties to the lower index;
    padding (index n) adds nothing."""
    idx = torch.cat([a[1], b[1]])
    val = torch.cat([a[0], b[0]])
    real = idx < n
    idx, val = idx[real], val[real]
    uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=val.dtype, device=val.device)
    sums.index_add_(0, inv, val)
    if uniq.shape[0] <= k:
        pad = k - uniq.shape[0]
        return (torch.cat([sums, sums.new_zeros(pad)]),
                torch.cat([uniq, uniq.new_full((pad,), n)]))
    sel = _k_largest(sums.abs(), k)
    return sums[sel], uniq[sel]


def tree(sets: List[Tuple[torch.Tensor, torch.Tensor]], k: int, n: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global set of P (a power of two) local sets."""
    p = len(sets)
    if p & (p - 1):
        raise ValueError(f"the reference tree takes a power of two, not {p}")
    bit = 1
    while bit < p:
        sets = [merge(sets[a], sets[a ^ bit], k, n) for a in range(p)]
        bit <<= 1
    return sets[0]


def step(grads: List[torch.Tensor], residuals: List[torch.Tensor], k: int
         ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """(update, new residuals, kept masks) of one gTop-k step over the
    workers' flat gradients; a kept mask marks the entries whose value
    reached the update (the residual is 0 there)."""
    p, n = len(grads), grads[0].shape[0]
    accs = [g + e for g, e in zip(grads, residuals)]
    if p == 1:
        keep = threshold_keep(accs[0], k)
        update = torch.where(keep, accs[0], torch.zeros_like(accs[0]))
        return update, [torch.where(keep, torch.zeros_like(accs[0]),
                                    accs[0])], [keep]
    local = [local_set(a, k) for a in accs]
    gval, gidx = tree(local, k, n)
    update = torch.zeros(n, dtype=torch.float32, device=grads[0].device)
    real = gidx < n
    update.index_add_(0, gidx[real], gval[real])
    update = update * (1.0 / p)
    in_g = torch.zeros(n + 1, dtype=torch.bool, device=grads[0].device)
    in_g[gidx] = True
    in_g[n] = False
    new_res, kept = [], []
    for acc, (val, idx) in zip(accs, local):
        picked = torch.zeros(n + 1, dtype=torch.bool, device=acc.device)
        picked[idx] = True
        picked = picked[:n]
        delivered = picked & in_g[:n]
        new_res.append(torch.where(delivered, torch.zeros_like(acc), acc))
        kept.append(delivered)
    return update, new_res, kept


def sgd(p: torch.Tensor, update: torch.Tensor, velocity, lr: float,
        momentum: float, wd: float):
    """(new parameters, new velocity); `velocity` None at the first
    step."""
    d = update + wd * p
    v = d.clone() if velocity is None else momentum * velocity + d
    return p - lr * v, v
