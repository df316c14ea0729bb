"""The gradient all-reduce over ``torch.distributed``: the gTop-k hypercube
and the dense baseline.

Counterpart of ``gtopkssgd_tpu/parallel/collectives.py`` for flat
``gtopk`` with the ``tree`` schedule and the fp32 wire, and for ``dense``.
There every device runs the same SPMD program and ``lax.ppermute`` moves
the sets; here each rank is one process of a process group and a round is
one ``dist.batch_isend_irecv`` (NCCL on the card, gloo on the CPU).

* ``gtopk_allreduce`` -- the masked hypercube of merge-then-reselect
  rounds (``ops.merge_sparse_sets``): the e = P - 2^m extra ranks fold
  their sets into ranks [0, e), the 2^m block runs log2(m) hypercube
  rounds, and the extras adopt the finished set. Every rank ends with
  bitwise the same global set. A rank that receives nothing in a round
  still merges, with a set of pure sentinels, as the JAX tree does.
* ``merge_tree_ref`` -- the same tree over a list of P sets in one
  process: the plain reference the tests and ``chip_smoke.py`` hold the
  collective to. The training path never calls it.
* ``dense_allreduce`` -- one all-reduce (sum) of the flat gradient.

A wire set is one int32 buffer of 2k words: the values' bits, then the
indices. ``wire`` counts what this process shipped in the gradient
exchange: bytes it sent and tree rounds it ran (a rank of a ragged tree
sends in some rounds only).

Gloo has no send/recv of CUDA tensors: when a gloo group carries CUDA
tensors (ranks sharing one card), each buffer is copied to the host and
back around the call -- 8k bytes a set (2,184 at ResNet-20), 4N for the
dense all-reduce.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gtopkssgd_tpu_torch.modes import DENSE_MODES, GTOPK_MODES
from gtopkssgd_tpu_torch.ops.topk import merge_sparse_sets

Set = Tuple[torch.Tensor, torch.Tensor]

# The JAX package's other modes and its balanced schedule come with
# ROADMAP.md section 1, item 5; its int8/fp8 codecs with item 4.
_LATER_MODES = ("gtopk_hier", "gtopk_layerwise", "allgather", "topk",
                "topkA", "topk_allgather")
_LATER_ITEM = "ROADMAP.md section 1, item 5"
_CODEC_ITEM = "ROADMAP.md section 1, item 4"

#: Gradient-exchange traffic of this process since ``reset_wire()``.
wire: Dict[str, int] = {"bytes": 0, "rounds": 0}


def reset_wire() -> None:
    for key in wire:
        wire[key] = 0


def _check_codec(codec) -> None:
    if getattr(codec, "name", codec) != "fp32":
        raise ValueError(
            f"codec {codec!r}: the port ships fp32 sets only; the int8/fp8 "
            f"codecs come with {_CODEC_ITEM}")


def _check_mode(mode, schedule) -> None:
    """Refuse all but flat gtopk over the tree (None and 'auto' mean it)."""
    if mode in _LATER_MODES or schedule == "balanced":
        raise ValueError(f"mode {mode!r}, schedule {schedule!r}: not in "
                         f"the port yet, {_LATER_ITEM}")
    if mode not in GTOPK_MODES:
        raise ValueError(f"unknown sparse mode {mode!r}")
    if schedule not in (None, "auto", "tree"):
        raise ValueError(f"mode {mode!r} has schedule 'tree', got "
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


def merge_tree_ref(sets: Sequence[Set], k: int, n: int) -> List[Set]:
    """The set each of P = len(sets) ranks ends with after the tree, in
    one process: the same rounds, merges and sentinel sets as
    ``gtopk_allreduce``."""
    sets = list(sets)
    q = len(sets)
    if q == 1:
        return sets
    plan = _tree_plan(q)
    m = 1 << (q.bit_length() - 1)
    for i, pairs in enumerate(plan):
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


def _pack(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.cat([vals.contiguous().view(torch.int32),
                      idx.to(torch.int32)])


def _unpack(buf: torch.Tensor, k: int) -> Set:
    return buf[:k].view(torch.float32), buf[k:]


def gtopk_allreduce(vals: torch.Tensor, idx: torch.Tensor, *, k: int,
                    n: int, group=None, codec="fp32") -> Set:
    """The global gTop-k set of this rank's local set (vals f32[k], idx
    i32[k], unique real indices, padding index n), bitwise the same on
    every rank of `group` (default: the whole world). Values are sums over
    the ranks that contributed; divide by P for the mean."""
    _check_codec(codec)
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
        got = _ship(_pack(vals, idx), send_to, recv_from, group)
        wire["rounds"] += 1
        if q > m and i == len(plan) - 1:  # unfold: the extras adopt
            if got is not None:
                vals, idx = _unpack(got, k)
            continue
        other = _sentinel(k, n, vals) if got is None else _unpack(got, k)
        vals, idx = merge_sparse_sets(vals, idx, *other, k, n)
    return vals, idx


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
                     plan=None) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """(gvals, gidx, needs_repair) for a sparse mode; the port has flat
    ``gtopk`` over the ``tree`` schedule (None and 'auto' resolve to it).
    Every other mode or schedule names the queue item that brings it."""
    schedule = getattr(plan, "schedule", plan)
    _check_mode(mode, schedule)
    gvals, gidx = gtopk_allreduce(vals, idx, k=k, n=n, group=group,
                                  codec=codec)
    return gvals, gidx, True


def comm_bytes_per_step(mode: str, n: int, k: int, p: int, codec="fp32",
                        schedule=None) -> int:
    """Bytes a rank ships per step, by the model of the JAX package: gtopk
    one 8k-byte fp32 set per tree round (at least one), dense 4N."""
    _check_codec(codec)
    if mode in DENSE_MODES:
        return 4 * n
    _check_mode(mode, schedule)
    return 8 * k * max(1, tree_rounds(p))
