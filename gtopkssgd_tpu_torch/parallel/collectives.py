"""The gradient exchange over ``torch.distributed``: the gTop-k hypercube,
the Top-k allgather baseline and the dense all-reduce.

Counterpart of ``gtopkssgd_tpu/parallel/collectives.py`` for flat
``gtopk`` over the ``tree`` schedule, the allgather modes (``allgather |
topk | topkA | topk_allgather``) and ``dense``, with every wire codec of
``parallel.codec``. There every device runs the same SPMD program and
``lax.ppermute`` / ``lax.all_gather`` move the sets; here each rank is one
process of a process group and a tree round is one
``dist.batch_isend_irecv`` (NCCL on the card, gloo on the CPU).

* ``gtopk_allreduce`` -- the masked hypercube of merge-then-reselect
  rounds (``ops.merge_sparse_sets``): the e = P - 2^m extra ranks fold
  their sets into ranks [0, e), the 2^m block runs log2(m) hypercube
  rounds, and the extras adopt the finished set. Every round each rank
  encodes its set, ships the wire, and merges decode(own wire) with
  decode(partner wire), or with a set of pure sentinels where it
  receives nothing; in the unfold the extras adopt decode(partner wire)
  and the others decode(own wire). Encode is deterministic, so partners
  merge the same pair of sets and every rank ends with bitwise the same
  global set, under a lossy codec too.
* ``topk_allgather`` -- encode, gather every rank's wire, decode the P
  slices and add them into a dense f32[n] one rank at a time, rank 0
  first. Within one set the real indices are unique, so each
  ``index_add_`` is exact on the card too, and the sums come out in the
  order of the JAX package's scatter over the concatenated sets.
* ``merge_tree_ref`` -- the same tree over a list of P sets in one
  process: the plain reference the tests and ``chip_smoke.py`` hold the
  collective to. The training path never calls it.
* ``dense_allreduce`` -- one all-reduce (sum) of the flat gradient.

``wire`` counts what this process shipped in the gradient exchange, in
encoded bytes, and the rounds it ran. A tree round counts the wire this
rank sent in it (a rank of a ragged tree sends in some rounds only). The
allgather counts one round and one encoded set per rank of the gather,
P x the set's bytes, the convention of ``comm_bytes_per_step`` (the set
reaches P - 1 ranks, and P - 1 sets come in).

Gloo has no send/recv of CUDA tensors: when a gloo group carries CUDA
tensors (ranks sharing one card), each wire is copied to the host and
back around the call -- 8k bytes a set under fp32 (2,184 at ResNet-20),
4N for the dense all-reduce.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gtopkssgd_tpu_torch.modes import (
    ALLGATHER_MODES,
    DENSE_MODES,
    GTOPK_MODES,
)
from gtopkssgd_tpu_torch.ops.topk import merge_sparse_sets
from gtopkssgd_tpu_torch.parallel.codec import get_codec

Set = Tuple[torch.Tensor, torch.Tensor]

# The JAX package's hierarchical and layer-wise modes and its balanced
# schedule come with ROADMAP.md section 1, item 5.
_LATER_MODES = ("gtopk_hier", "gtopk_layerwise")
_LATER_ITEM = "ROADMAP.md section 1, item 5"

#: Gradient-exchange traffic of this process since ``reset_wire()``.
wire: Dict[str, int] = {"bytes": 0, "rounds": 0}


def reset_wire() -> None:
    for key in wire:
        wire[key] = 0


def _check_mode(mode, schedule) -> None:
    """Refuse what the port does not have yet, an unknown mode, and a
    schedule that does not realize the mode (None and 'auto' resolve to
    'tree' for gtopk, 'allgather' for the allgather modes)."""
    if mode in _LATER_MODES or schedule == "balanced":
        raise ValueError(f"mode {mode!r}, schedule {schedule!r}: not in "
                         f"the port yet, {_LATER_ITEM}")
    if mode in GTOPK_MODES:
        own = "tree"
    elif mode in ALLGATHER_MODES:
        own = "allgather"
    else:
        raise ValueError(f"unknown sparse mode {mode!r}")
    if schedule not in (None, "auto", own):
        raise ValueError(f"mode {mode!r} has schedule {own!r}, got "
                         f"{schedule!r}")


def _is_pow2(p: int) -> bool:
    return p > 0 and (p & (p - 1)) == 0


def tree_rounds(q: int) -> int:
    """Exchange rounds of the merge tree over q participants: log2(q) at
    powers of two, plus a fold and an unfold round at ragged q."""
    if q <= 1:
        return 0
    if _is_pow2(q):
        return int(math.log2(q))
    return (q.bit_length() - 1) + 2


def _tree_plan(q: int) -> List[List[Tuple[int, int]]]:
    """The tree's rounds as (source, destination) pairs: fold, hypercube
    rounds, unfold. The unfold round's receivers adopt, the others merge."""
    m = 1 << (q.bit_length() - 1)  # largest power of two <= q
    e = q - m                      # extra participants [m, q)
    rounds = []
    if e:
        rounds.append([(m + t, t) for t in range(e)])
    for r in range(int(math.log2(m))):
        rounds.append([(a, a ^ (1 << r)) for a in range(m)])
    if e:
        rounds.append([(t, m + t) for t in range(e)])
    return rounds


def _sentinel(k: int, n: int, like: torch.Tensor) -> Set:
    return (torch.zeros(k, dtype=torch.float32, device=like.device),
            torch.full((k,), n, dtype=torch.int32, device=like.device))


def merge_tree_ref(sets: Sequence[Set], k: int, n: int,
                   codec="fp32") -> List[Set]:
    """The set each of P = len(sets) ranks ends with after the tree, in
    one process: the same rounds, codec round trips, merges and sentinel
    sets as ``gtopk_allreduce``."""
    codec = get_codec(codec)
    sets = list(sets)
    q = len(sets)
    if q == 1:
        return sets
    plan = _tree_plan(q)
    m = 1 << (q.bit_length() - 1)
    for i, pairs in enumerate(plan):
        # What each rank ships is its wire; what anyone merges is a decode.
        sets = [codec.decode(codec.encode(v, x, n=n), k=k, n=n)
                for v, x in sets]
        recv = {dst: sets[src] for src, dst in pairs}
        if q > m and i == len(plan) - 1:  # unfold: the extras adopt
            sets = [recv.get(r, sets[r]) for r in range(q)]
            continue
        sets = [merge_sparse_sets(*sets[r],
                                  *recv.get(r, _sentinel(k, n, sets[r][0])),
                                  k, n)
                for r in range(q)]
    return sets


def _stages_on_host(t: torch.Tensor, group) -> bool:
    """True where a gloo group carries a CUDA tensor: it goes by host."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _ship(buf: torch.Tensor, send_to: Optional[int],
          recv_from: Optional[int], group) -> Optional[torch.Tensor]:
    """One point-to-point round: send `buf` to group rank `send_to` and
    receive a buffer like it from `recv_from` (either may be None)."""
    host = _stages_on_host(buf, group)
    out = None
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, buf.cpu() if host else buf,
                              dist.get_global_rank(group, send_to), group))
        wire["bytes"] += buf.numel() * buf.element_size()
    if recv_from is not None:
        out = torch.empty_like(buf, device="cpu" if host else buf.device)
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, recv_from), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if out is not None and host:
        out = out.to(buf.device)
    return out


def gtopk_allreduce(vals: torch.Tensor, idx: torch.Tensor, *, k: int,
                    n: int, group=None, codec="fp32") -> Set:
    """The global gTop-k set of this rank's local set (vals f32[k], idx
    i32[k], unique real indices, padding index n), bitwise the same on
    every rank of `group` (default: the whole world). Values are sums over
    the ranks that contributed; divide by P for the mean. Every round
    ships ``codec``'s wire of the set."""
    codec = get_codec(codec)
    group = group or dist.group.WORLD
    q = dist.get_world_size(group)
    if q == 1:
        return vals, idx
    me = dist.get_rank(group)
    plan = _tree_plan(q)
    m = 1 << (q.bit_length() - 1)
    for i, pairs in enumerate(plan):
        send_to = next((d for s, d in pairs if s == me), None)
        recv_from = next((s for s, d in pairs if d == me), None)
        buf = codec.encode(vals, idx, n=n)
        got = _ship(buf, send_to, recv_from, group)
        wire["rounds"] += 1
        own = codec.decode(buf, k=k, n=n)
        other = None if got is None else codec.decode(got, k=k, n=n)
        if q > m and i == len(plan) - 1:  # unfold: the extras adopt
            vals, idx = own if other is None else other
            continue
        if other is None:
            other = _sentinel(k, n, vals)
        vals, idx = merge_sparse_sets(*own, *other, k, n)
    return vals, idx


def topk_allgather(vals: torch.Tensor, idx: torch.Tensor, *, k: int,
                   n: int, group=None, codec="fp32") -> torch.Tensor:
    """The Top-k S-SGD baseline (modes allgather | topk | topkA |
    topk_allgather): the dense f32[n] sum of every rank's local set,
    bitwise the same on every rank. No global reselect, so every local
    pick lands and nothing needs repair."""
    codec = get_codec(codec)
    group = group or dist.group.WORLD
    p = dist.get_world_size(group)
    buf = codec.encode(vals, idx, n=n)
    wire["bytes"] += buf.numel() * buf.element_size() * p
    wire["rounds"] += 1
    host = _stages_on_host(buf, group)
    mine = buf.cpu() if host else buf
    parts = [torch.empty_like(mine) for _ in range(p)]
    dist.all_gather(parts, mine, group=group)
    out = torch.zeros(n + 1, dtype=torch.float32, device=vals.device)
    for part in parts:  # rank order; padding adds into slot n and drops
        v, i = codec.decode(part.to(vals.device), k=k, n=n)
        out.index_add_(0, i.clamp(max=n).long(), v)
    return out[:n]


def dense_allreduce(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """Sum of `x` over the ranks of `group` (a new tensor)."""
    group = group or dist.group.WORLD
    wire["bytes"] += x.numel() * x.element_size()
    return _all_reduce_sum(x, group)


def pmean(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """Mean of `x` over the ranks of `group` (a new tensor); not counted
    in ``wire``, which is the gradient exchange's."""
    group = group or dist.group.WORLD
    return _all_reduce_sum(x, group) / dist.get_world_size(group)


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    host = _stages_on_host(x, group)
    out = x.cpu() if host else x.clone()
    dist.all_reduce(out, group=group)
    return out.to(x.device) if host else out


def sparse_allreduce(mode: str, vals: torch.Tensor, idx: torch.Tensor, *,
                     k: int, n: int, group=None, codec="fp32",
                     plan=None) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                         bool]:
    """(result, gidx, needs_repair) for a sparse mode:

    * ``gtopk`` -> (gvals f32[k], gidx i32[k], True), over the ``tree``;
    * the allgather modes -> (the dense summed update f32[n], None,
      False): every local pick is applied, so there is nothing to repair.

    ``plan`` is a schedule name or anything with a ``.schedule``; None
    and 'auto' resolve to the mode's own. Every other mode or schedule
    names the queue item that brings it."""
    schedule = getattr(plan, "schedule", plan)
    _check_mode(mode, schedule)
    if mode in ALLGATHER_MODES:
        dense = topk_allgather(vals, idx, k=k, n=n, group=group,
                               codec=codec)
        return dense, None, False
    gvals, gidx = gtopk_allreduce(vals, idx, k=k, n=n, group=group,
                                  codec=codec)
    return gvals, gidx, True


def comm_bytes_per_step(mode: str, n: int, k: int, p: int, codec="fp32",
                        schedule=None) -> int:
    """Bytes a rank ships per step, by the model of the JAX package: one
    encoded k-of-n set (``codec.wire_set_bytes``) per tree round (at
    least one) for gtopk, one per rank for the allgather modes, 4N for
    dense."""
    set_bytes = get_codec(codec).wire_set_bytes(k, n)
    if mode in DENSE_MODES:
        return 4 * n
    _check_mode(mode, schedule)
    if mode in ALLGATHER_MODES:
        return set_bytes * p
    return set_bytes * max(1, tree_rounds(p))
