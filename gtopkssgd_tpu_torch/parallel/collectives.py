"""The gradient exchange over ``torch.distributed``: the gTop-k hypercube
(flat, hierarchical, layer-wise), the balanced split-and-reduce, the Top-k
allgather baseline and the dense all-reduce.

Counterpart of ``gtopkssgd_tpu/parallel/collectives.py`` for every mode
and schedule, with every wire codec of ``parallel.codec``. There every
device runs the same SPMD program and ``lax.ppermute`` /
``lax.all_gather`` move the sets; here each rank is one process of a
process group and a round is one ``dist.batch_isend_irecv`` (NCCL on the
card, gloo on the CPU).

* ``gtopk_allreduce`` -- the masked hypercube of merge-then-reselect
  rounds (``ops.merge_sparse_sets``) over the ranks: the e = P - 2^m
  extra participants fold their sets into participants [0, e), the 2^m
  block runs log2(m) hypercube rounds, and the extras adopt the finished
  set. Every round each rank encodes its set, ships the wire, and merges
  decode(own wire) with decode(partner wire), or with a set of pure
  sentinels where it receives nothing; in the unfold the extras adopt
  decode(partner wire) and the others decode(own wire). Encode is
  deterministic, so partners merge the same pair of sets and every rank
  ends with bitwise the same global set, under a lossy codec too.
* ``ici_dense_psum`` and ``hier_gtopk_allreduce`` -- the hierarchical
  mode: a dense sum within each contiguous slice of ``ici_size`` ranks
  by recursive doubling (extras folded into the largest power-of-two
  block and sent the sum back), bitwise the same on every member of a
  slice; then the same tree over the slices, participant s being the
  slice's ranks, rank (s, j) exchanging with rank (s', j).
* ``balanced_gtopk_allreduce`` -- the Ok-Topk schedule: rank r owns the
  index range [r*chunk, (r+1)*chunk); p - 1 scatter rounds ship each
  owner its at most ``balanced_cap`` largest picks in its range, each
  owner keeps the top cap of its summed range, and an all-gather of the
  owner sets ends in one shared reselect of k.
* ``topk_allgather`` -- encode, gather every rank's wire, decode the P
  slices and add them into a dense f32[n] one rank at a time, rank 0
  first. Within one set the real indices are unique, so each
  ``index_add_`` is exact on the card too, and the sums come out in the
  order of the JAX package's scatter over the concatenated sets.
* ``merge_tree_ref`` -- the same tree over a list of P sets in one
  process: the plain reference the tests and ``chip_smoke.py`` hold the
  collective to. The training path never calls it.
* ``dense_allreduce`` -- one all-reduce (sum) of the flat gradient.

Ties in the balanced schedule's three top-k's go to the lowest position,
as ``lax.top_k`` breaks them (``ops.topk._topk_order``).

``wire`` counts what this process shipped in the gradient exchange, in
encoded bytes, and the rounds it ran. A tree round counts the wire this
rank sent in it (a rank of a ragged tree sends in some rounds only). An
all-gather counts one round and one encoded set per rank of the gather,
P x the set's bytes, the convention of ``comm_bytes_per_step`` (the set
reaches P - 1 ranks, and P - 1 sets come in); so the balanced schedule
counts p - 1 scatter sets and p gathered ones, 2p - 1 cap-sets. The
in-slice dense sum of the hierarchical mode counts the 4N buffers this
rank sends in it (``ici_psum_sends``) and no round; the model counts 4N
once, which is what each rank sends in a slice of 2.

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
    HIER_MODES,
    LAYERWISE_MODES,
)
from gtopkssgd_tpu_torch.ops.topk import _topk_order, merge_sparse_sets
from gtopkssgd_tpu_torch.parallel.codec import get_codec

Set = Tuple[torch.Tensor, torch.Tensor]

#: Gradient-exchange traffic of this process since ``reset_wire()``.
wire: Dict[str, int] = {"bytes": 0, "rounds": 0}


def reset_wire() -> None:
    for key in wire:
        wire[key] = 0


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
    """The tree's rounds as (source, destination) participant pairs:
    fold, hypercube rounds, unfold. The unfold round's receivers adopt,
    the others merge."""
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
        # gloo ships a CUDA tensor by host: the copy is the transport.
        # graftlint: disable=host-sync-in-jit
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


def _merge_tree(vals: torch.Tensor, idx: torch.Tensor, *, k: int, n: int,
                group, part_ranks: Sequence[Sequence[int]], codec) -> Set:
    """The masked hypercube over q = len(part_ranks) participants;
    ``part_ranks[a]`` are the group ranks holding participant a's set (all
    lists of one length), each running its own copy of the tree: rank j of
    participant a exchanges with rank j of its partner. Precondition: the
    ranks of a participant hold bitwise the same set."""
    codec = get_codec(codec)
    q = len(part_ranks)
    if q == 1:
        return vals, idx
    me = dist.get_rank(group)
    part, j = next((a, ranks.index(me)) for a, ranks in enumerate(part_ranks)
                   if me in ranks)
    plan = _tree_plan(q)
    m = 1 << (q.bit_length() - 1)
    for i, pairs in enumerate(plan):
        send_to = next((part_ranks[d][j] for s, d in pairs if s == part),
                       None)
        recv_from = next((part_ranks[s][j] for s, d in pairs if d == part),
                         None)
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


def gtopk_allreduce(vals: torch.Tensor, idx: torch.Tensor, *, k: int,
                    n: int, group=None, codec="fp32") -> Set:
    """The global gTop-k set of this rank's local set (vals f32[k], idx
    i32[k], unique real indices, padding index n), bitwise the same on
    every rank of `group` (default: the whole world). Values are sums over
    the ranks that contributed; divide by P for the mean. Every round
    ships ``codec``'s wire of the set."""
    group = group or dist.group.WORLD
    q = dist.get_world_size(group)
    return _merge_tree(vals, idx, k=k, n=n, group=group,
                       part_ranks=[[r] for r in range(q)], codec=codec)


def ici_dense_psum(x: torch.Tensor, *, ici_size: int,
                   group=None) -> torch.Tensor:
    """The sum of `x` over this rank's slice, the contiguous block of
    `ici_size` ranks it belongs to (rank r is in slice r // ici_size),
    bitwise the same on every member: recursive doubling over the slice
    offsets, where each round adds two operands that are the same up to
    commutation; at a slice size that is not a power of two the extra
    offsets fold into the largest power-of-two block first and receive
    the finished sum at the end. Counts in ``wire`` the bytes this rank
    ships, ``ici_psum_sends(offset, ici_size)`` buffers of 4N (4N at
    ici_size 2, where that equals the model's in-slice term), and no
    round: ``rounds`` counts the sparse exchange only."""
    if ici_size <= 1:
        return x
    group = group or dist.group.WORLD
    p, s = dist.get_world_size(group), ici_size
    if p % s != 0:
        raise ValueError(f"axis size {p} not divisible by ici_size={s}")
    me = dist.get_rank(group)
    j, base = me % s, me - me % s

    def ship(send_to, recv_from):
        return _ship(x, None if send_to is None else base + send_to,
                     None if recv_from is None else base + recv_from,
                     group)

    m = 1 << (s.bit_length() - 1)  # largest power of two <= s
    e = s - m                      # extra offsets [m, s)
    if j >= m:
        ship(j - m, None)
    elif j < e:
        x = x + ship(None, j + m)
    if j < m:
        r = 1
        while r < m:
            x = x + ship(j ^ r, j ^ r)
            r <<= 1
    if j < e:
        ship(j + m, None)
    elif j >= m:
        x = ship(None, j - m)
    return x


def ici_psum_sends(offset: int, ici_size: int) -> int:
    """How many buffers slice offset `offset` ships in ``ici_dense_psum``:
    its fold (an extra offset) or the unfold it returns (an offset below
    the extras), and one a doubling round inside the power-of-two block."""
    if ici_size <= 1:
        return 0
    m = 1 << (ici_size.bit_length() - 1)
    if offset >= m:
        return 1
    return (m.bit_length() - 1) + (offset < ici_size - m)


def hier_gtopk_allreduce(vals: torch.Tensor, idx: torch.Tensor, *, k: int,
                         n: int, ici_size: int, group=None,
                         codec="fp32") -> Set:
    """The gTop-k tree across the P / ici_size slices of `group`: every
    rank of a slice holds the same local set (selected from the
    ``ici_dense_psum`` of the gradient) and runs its own copy of the tree
    with the rank of the same offset in each partner slice."""
    group = group or dist.group.WORLD
    n_slices = dist.get_world_size(group) // ici_size
    part_ranks = [[s * ici_size + j for j in range(ici_size)]
                  for s in range(n_slices)]
    return _merge_tree(vals, idx, k=k, n=n, group=group,
                       part_ranks=part_ranks, codec=codec)


def balanced_cap(k: int, p: int, n: int) -> int:
    """Picks a rank ships to each owner: ceil(1.5 k / p), at most k and at
    most the owner's range ceil(n / p). Picks beyond it never reach their
    owner, and the error-feedback repair restores them."""
    cap = -(-3 * k // (2 * p))
    return max(1, min(cap, k, -(-n // p)))


def _gather_wires(buf: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `buf` in rank order, on `buf`'s device; counts one
    round and P x the buffer in ``wire``."""
    p = dist.get_world_size(group)
    wire["bytes"] += buf.numel() * buf.element_size() * p
    wire["rounds"] += 1
    host = _stages_on_host(buf, group)
    # gloo gathers a CUDA tensor by host: the copy is the transport.
    mine = buf.cpu() if host else buf  # graftlint: disable=host-sync-in-jit
    parts = [torch.empty_like(mine) for _ in range(p)]
    dist.all_gather(parts, mine, group=group)
    return [part.to(buf.device) for part in parts]


def _balanced_shipment(vals: torch.Tensor, idx: torch.Tensor, dest: int,
                       chunk: int, cap: int, n: int, p: int) -> Set:
    """The at most `cap` largest picks of (vals, idx) in owner `dest`'s
    range (ties to the lowest slot), padded with sentinels."""
    owner = torch.clamp(torch.div(idx, chunk, rounding_mode="floor"),
                        max=p - 1)
    mag = torch.where((idx < n) & (owner == dest), vals.abs(), -1.0)
    pos = _topk_order(mag, cap)
    sel = mag[pos] >= 0.0
    return (torch.where(sel, vals[pos], 0.0),
            torch.where(sel, idx[pos], n).to(torch.int32))


def _balanced_accumulate(acc: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor, off: int, n: int) -> None:
    """Add picks into owned range acc[:chunk] (f32[chunk + 1]); anything
    outside it, the sentinel n included (which can alias into the last
    owner's slots when n < chunk*p), lands in the dropped slot `chunk`."""
    chunk = acc.shape[0] - 1
    loc = idx.long() - off
    ok = (idx < n) & (loc >= 0) & (loc < chunk)
    acc.index_add_(0, torch.where(ok, loc, chunk),
                   torch.where(ok, vals, 0.0))


def _balanced_owner_set(acc: torch.Tensor, cap: int, off: int,
                        n: int) -> Set:
    """The top `cap` of the reduced range by magnitude (zeros ->
    sentinel), in global indices."""
    acc = acc[:-1]
    pos = _topk_order(acc.abs(), cap)
    keep = acc[pos].abs() > 0.0
    return (torch.where(keep, acc[pos], 0.0),
            torch.where(keep, pos + off, n).to(torch.int32))


def _balanced_reselect(owner_sets: Sequence[Set], k: int, n: int) -> Set:
    """The top k of the owner sets, concatenated in rank order."""
    cvals = torch.cat([v for v, _ in owner_sets])
    cidx = torch.cat([i for _, i in owner_sets])
    fmag = torch.where(cidx < n, cvals.abs(), -1.0)
    fpos = _topk_order(fmag, k)
    fkeep = fmag[fpos] > 0.0
    return (torch.where(fkeep, cvals[fpos], 0.0),
            torch.where(fkeep, cidx[fpos], n).to(torch.int32))


def balanced_gtopk_allreduce(vals: torch.Tensor, idx: torch.Tensor, *,
                             k: int, n: int, group=None,
                             codec="fp32") -> Set:
    """The Ok-Topk split-and-reduce (arXiv:2201.07598): a global k-set,
    bitwise the same on every rank, with the tree's repair contract. Rank
    r owns [r*chunk, (r+1)*chunk), chunk = ceil(n/p). Scatter: in round s
    (1 <= s < p) each rank ships rank (r+s) mod p the at most cap largest
    of its picks in that rank's range; own-range picks add in place.
    Reduce: each owner sums what it holds into f32[chunk] and keeps the
    top cap by magnitude (zeros -> sentinel). Gather: every rank gathers
    the p encoded owner sets and reselects the top k of the p*cap."""
    codec = get_codec(codec)
    group = group or dist.group.WORLD
    p = dist.get_world_size(group)
    if p == 1:
        return vals, idx
    chunk = -(-n // p)
    cap = balanced_cap(k, p, n)
    r = dist.get_rank(group)
    acc = torch.zeros(chunk + 1, dtype=torch.float32, device=vals.device)
    _balanced_accumulate(acc, vals, idx, r * chunk, n)  # own range only
    for s in range(1, p):
        wire_set = _balanced_shipment(vals, idx, (r + s) % p, chunk, cap, n,
                                      p)
        got = _ship(codec.encode(*wire_set, n=n), (r + s) % p, (r - s) % p,
                    group)
        wire["rounds"] += 1
        _balanced_accumulate(acc, *codec.decode(got, k=cap, n=n),
                             r * chunk, n)
    own = _balanced_owner_set(acc, cap, r * chunk, n)
    parts = [codec.decode(w, k=cap, n=n) for w in
             _gather_wires(codec.encode(*own, n=n), group)]
    return _balanced_reselect(parts, k, n)


def balanced_ref(sets: Sequence[Set], k: int, n: int,
                 codec="fp32") -> List[Set]:
    """The set each of P = len(sets) ranks ends with after the balanced
    schedule, in one process: the same shipments, codec round trips,
    owner sums (own picks first, then round 1, 2, ...), owner sets and
    reselect as ``balanced_gtopk_allreduce``."""
    codec = get_codec(codec)
    p = len(sets)
    if p == 1:
        return list(sets)
    chunk = -(-n // p)
    cap = balanced_cap(k, p, n)
    owner_sets = []
    for r in range(p):
        acc = torch.zeros(chunk + 1, dtype=torch.float32,
                          device=sets[r][0].device)
        _balanced_accumulate(acc, *sets[r], r * chunk, n)
        for s in range(1, p):
            shipped = _balanced_shipment(*sets[(r - s) % p], r, chunk, cap,
                                         n, p)
            _balanced_accumulate(
                acc, *codec.decode(codec.encode(*shipped, n=n), k=cap, n=n),
                r * chunk, n)
        owner_sets.append(codec.decode(codec.encode(
            *_balanced_owner_set(acc, cap, r * chunk, n), n=n), k=cap, n=n))
    return [_balanced_reselect(owner_sets, k, n)] * p


def topk_allgather(vals: torch.Tensor, idx: torch.Tensor, *, k: int,
                   n: int, group=None, codec="fp32") -> torch.Tensor:
    """The Top-k S-SGD baseline (modes allgather | topk | topkA |
    topk_allgather): the dense f32[n] sum of every rank's local set,
    bitwise the same on every rank. No global reselect, so every local
    pick lands and nothing needs repair."""
    codec = get_codec(codec)
    group = group or dist.group.WORLD
    out = torch.zeros(n + 1, dtype=torch.float32, device=vals.device)
    for part in _gather_wires(codec.encode(vals, idx, n=n), group):
        # rank order; padding adds into slot n and drops
        v, i = codec.decode(part, k=k, n=n)
        out.index_add_(0, i.clamp(max=n).long(), v)
    return out[:n]


def dense_allreduce(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """Sum of `x` over the ranks of `group` (a new tensor)."""
    group = group or dist.group.WORLD
    wire["bytes"] += x.numel() * x.element_size()
    return _all_reduce_sum(x, group)


def psum(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """Sum of `x` over the ranks of `group` (a new tensor); not counted
    in ``wire``, which is the gradient exchange's."""
    return _all_reduce_sum(x, group or dist.group.WORLD)


def pmean(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """Mean of `x` over the ranks of `group` (a new tensor); not counted
    in ``wire``."""
    group = group or dist.group.WORLD
    return psum(x, group=group) / dist.get_world_size(group)


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    host = _stages_on_host(x, group)
    # gloo sums a CUDA tensor by host: the copy is the transport.
    out = x.cpu() if host else x.clone()  # graftlint: disable=host-sync-in-jit
    dist.all_reduce(out, group=group)
    return out.to(x.device) if host else out


def _schedule(mode, plan) -> Optional[str]:
    """The schedule `plan` names (a name, anything with ``.schedule``, or
    None), checked against what realizes `mode`."""
    schedule = getattr(plan, "schedule", plan)
    if mode in GTOPK_MODES or mode in LAYERWISE_MODES:
        if schedule not in (None, "auto", "tree", "balanced"):
            raise ValueError(
                f"mode {mode!r} supports schedules 'tree'/'balanced', "
                f"got {schedule!r}")
    elif mode in HIER_MODES + ALLGATHER_MODES:
        own = "tree" if mode in HIER_MODES else "allgather"
        if schedule not in (None, "auto", own):
            raise ValueError(f"mode {mode!r} has schedule {own!r}, got "
                             f"{schedule!r}")
    elif mode not in DENSE_MODES:
        raise ValueError(f"unknown sparse allreduce mode {mode!r}")
    return schedule


def sparse_allreduce(mode: str, vals: torch.Tensor, idx: torch.Tensor, *,
                     k: int, n: int, group=None, ici_size: int = 1,
                     codec="fp32", plan=None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor], bool]:
    """(result, gidx, needs_repair) for a sparse mode:

    * ``gtopk`` and ``gtopk_layerwise`` -> (gvals f32[k], gidx i32[k],
      True), over the ``tree`` or, where `plan` says so, ``balanced``;
    * ``gtopk_hier`` -> the same, the tree running across the slices of
      ``ici_size`` ranks (the gradient was summed within them first);
    * the allgather modes -> (the dense summed update f32[n], None,
      False): every local pick is applied, so there is nothing to repair.

    ``plan`` is a schedule name or anything with a ``.schedule``; None
    and 'auto' resolve to the mode's own."""
    if mode in DENSE_MODES:
        raise ValueError(f"unknown sparse allreduce mode {mode!r}")
    schedule = _schedule(mode, plan)
    if mode in ALLGATHER_MODES:
        dense = topk_allgather(vals, idx, k=k, n=n, group=group,
                               codec=codec)
        return dense, None, False
    if mode in HIER_MODES:
        gvals, gidx = hier_gtopk_allreduce(vals, idx, k=k, n=n,
                                           ici_size=ici_size, group=group,
                                           codec=codec)
    elif schedule == "balanced":
        gvals, gidx = balanced_gtopk_allreduce(vals, idx, k=k, n=n,
                                               group=group, codec=codec)
    else:
        gvals, gidx = gtopk_allreduce(vals, idx, k=k, n=n, group=group,
                                      codec=codec)
    return gvals, gidx, True


def comm_bytes_per_step(mode: str, n: int, k: int, p: int,
                        ici_size: int = 1, codec="fp32",
                        schedule=None) -> int:
    """Bytes a rank ships per step, by the model of the JAX package, one
    encoded k-of-n set being ``codec.wire_set_bytes(k, n)``: for gtopk and
    gtopk_layerwise one set per tree round (at least one), or under
    'balanced' 2p - 1 sets of ``balanced_cap`` picks; for gtopk_hier 4N
    within the slice (when it has more than one rank; ``ici_dense_psum``
    ships ``ici_psum_sends`` x 4N, which is 4N only in a slice of 2)
    plus one set per tree round across the slices; one set per rank for
    the allgather modes; 4N for dense."""
    c = get_codec(codec)
    if mode in DENSE_MODES:
        return 4 * n
    _schedule(mode, schedule)
    set_bytes = c.wire_set_bytes(k, n)
    if mode in GTOPK_MODES or mode in LAYERWISE_MODES:
        if schedule == "balanced":
            return (c.wire_set_bytes(balanced_cap(k, p, n), n)
                    * max(1, 2 * p - 1))
        return set_bytes * max(1, tree_rounds(p))
    if mode in HIER_MODES:
        n_slices = max(1, p // max(1, ici_size))
        dense = 4 * n if ici_size > 1 else 0
        return dense + set_bytes * tree_rounds(n_slices)
    return set_bytes * p
