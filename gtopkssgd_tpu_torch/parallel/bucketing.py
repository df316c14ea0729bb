"""Byte-balanced buckets of the layer-wise wire (``--buckets``), under the
``serial`` execution order (``--pipeline``).

Counterpart of ``gtopkssgd_tpu/parallel/bucketing.py``. The leaves (the
parameters in flat order) are cut into B contiguous buckets; each bucket
selects once with k_b = ceil(density * n_b) and merges over its own index
space [0, n_b). The partition minimizes the alpha-beta merge cost exactly
(an O(L^3) dynamic program over the L leaves):

    cost = sum over buckets of rounds(p, schedule) * alpha
                               + comm_bytes(n_b, k_b) / beta

with ``comm_bytes`` the model of ``collectives.comm_bytes_per_step`` (a
lossy codec's index words shrink with n_b, so splitting buys index bits
and costs alpha). Ties go to the partition whose largest bucket is
smallest, then to the earliest cut; under ``auto`` a larger B wins ties.

Spec grammar (``--buckets``): ``concat`` (per-leaf selection, one merge
of the concatenated sets over the global index space; no ``BucketPlan``),
``leaf`` (B = L), ``<int B>`` (B pinned, cuts placed by the DP) and
``auto`` (the DP picks B too). ``--pipeline`` takes ``serial``: bucket
b+1 selects after bucket b's merge. ``overlap`` and ``auto`` are not in
the port yet, so a plan carries no execution order of its own: it runs
``PIPELINE``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

from gtopkssgd_tpu_torch.ops.topk import k_for_density
from gtopkssgd_tpu_torch.parallel.collectives import (
    comm_bytes_per_step,
    tree_rounds,
)

BUCKETS_DEFAULT = "concat"
_WORD_SPECS = ("concat", "leaf", "auto")
#: The one execution order the port runs.
PIPELINE = "serial"
_LATER_PIPELINES = ("overlap", "auto")
_LATER_ITEM = "ROADMAP.md section 1, item 5"


def parse_pipeline(spec) -> str:
    """'serial'; 'overlap' and 'auto' are refused by their ROADMAP item,
    anything else as an invalid spec."""
    if isinstance(spec, str):
        word = spec.strip().lower()
        if word == "serial":
            return word
        if word in _LATER_PIPELINES:
            raise ValueError(f"--pipeline {word!r} is not in the port yet, "
                             f"{_LATER_ITEM}; it has 'serial'")
    raise ValueError(
        f"invalid --pipeline spec {spec!r}; grammar: serial | overlap | auto")


def parse_buckets(spec) -> object:
    """'concat' | 'leaf' | 'auto' | int B >= 1, from the CLI string or an
    int; ValueError on anything else."""
    if isinstance(spec, bool):
        raise ValueError(f"invalid --buckets spec {spec!r}")
    if isinstance(spec, int):
        if spec < 1:
            raise ValueError(f"--buckets count must be >= 1, got {spec}")
        return spec
    if isinstance(spec, str):
        word = spec.strip().lower()
        if word in _WORD_SPECS:
            return word
        try:
            count = int(word)
        except ValueError:
            raise ValueError(
                f"invalid --buckets spec {spec!r}; grammar: "
                "concat | leaf | auto | <int B>") from None
        if count < 1:
            raise ValueError(f"--buckets count must be >= 1, got {count}")
        return count
    raise ValueError(f"invalid --buckets spec {spec!r}")


def buckets_key(spec) -> str:
    """'concat' | 'leaf' | 'auto' | 'b{B}': the planner's key."""
    parsed = parse_buckets(spec)
    return parsed if isinstance(parsed, str) else f"b{parsed}"


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Bucket b covers leaves ``boundaries[b]:boundaries[b+1]`` (B + 1
    cuts, 0 first, L last) of ``leaf_sizes``; ``ks`` are the buckets' wire
    k."""

    boundaries: Tuple[int, ...]
    leaf_sizes: Tuple[int, ...]
    ks: Tuple[int, ...]
    spec: str = "auto"

    def __post_init__(self):
        L = len(self.leaf_sizes)
        b = self.boundaries
        if (len(b) < 2 or b[0] != 0 or b[-1] != L
                or any(b[i] >= b[i + 1] for i in range(len(b) - 1))):
            raise ValueError(
                f"boundaries {b} is not a partition of {L} leaves")
        if len(self.ks) != len(b) - 1:
            raise ValueError(f"{len(self.ks)} ks for {len(b) - 1} buckets")

    @property
    def n_buckets(self) -> int:
        return len(self.boundaries) - 1

    @property
    def sizes(self) -> Tuple[int, ...]:
        """n_b of every bucket."""
        return tuple(sum(self.leaf_sizes[lo:hi])
                     for lo, hi in zip(self.boundaries, self.boundaries[1:]))

    @property
    def k_total(self) -> int:
        return sum(self.ks)

    def leaf_range(self, b: int) -> Tuple[int, int]:
        return self.boundaries[b], self.boundaries[b + 1]

    def pairs(self) -> Tuple[Tuple[int, int], ...]:
        """((n_b, k_b), ...), what the wire models price."""
        return tuple(zip(self.sizes, self.ks))

    def to_manifest(self) -> dict:
        return {
            "buckets": self.spec,
            "bucket_boundaries": list(self.boundaries),
            "bucket_sizes": list(self.sizes),
            "bucket_ks": list(self.ks),
            "pipeline": PIPELINE,
        }

    @staticmethod
    def from_manifest(manifest: dict) -> Optional["BucketPlan"]:
        """The plan at bucket granularity (each bucket one leaf of its
        size); None when the manifest holds no buckets."""
        bounds = manifest.get("bucket_boundaries")
        sizes = manifest.get("bucket_sizes")
        ks = manifest.get("bucket_ks")
        if not bounds or not sizes or not ks:
            return None
        return BucketPlan(
            boundaries=tuple(range(len(sizes) + 1)),
            leaf_sizes=tuple(int(s) for s in sizes),
            ks=tuple(int(k) for k in ks),
            spec=str(manifest.get("buckets", "auto")),
        )


def merge_rounds(p: int, schedule: Optional[str] = None) -> int:
    """Latency-bearing rounds of one merge: the tree's rounds, or 2(p-1)
    for the balanced schedule (p-1 scatter, p-1 gather)."""
    if p <= 1:
        return 0
    if schedule == "balanced":
        return 2 * (p - 1)
    return tree_rounds(p)


def bucket_cost_ms(n_b: int, k_b: int, *, p: int, codec="fp32",
                   schedule: Optional[str] = None, alpha_ms: float,
                   beta_gbps: float, mode: str = "gtopk_layerwise") -> float:
    """Modeled ms of one bucket's merge: rounds * alpha + bytes / beta."""
    if p <= 1:
        return 0.0
    wire = comm_bytes_per_step(mode, n_b, k_b, p, codec=codec,
                               schedule=schedule)
    beta_bytes_per_ms = max(float(beta_gbps), 1e-9) * 1e9 / 1e3
    return (merge_rounds(p, schedule) * float(alpha_ms)
            + wire / beta_bytes_per_ms)


def partition_cost_ms(plan: BucketPlan, *, p: int, codec="fp32",
                      schedule: Optional[str] = None, alpha_ms: float,
                      beta_gbps: float,
                      mode: str = "gtopk_layerwise") -> float:
    """The DP's objective for `plan`: its buckets' merge costs, summed."""
    return sum(bucket_cost_ms(n_b, k_b, p=p, codec=codec, schedule=schedule,
                              alpha_ms=alpha_ms, beta_gbps=beta_gbps,
                              mode=mode)
               for n_b, k_b in plan.pairs())


@functools.lru_cache(maxsize=64)
def _dp_tables(leaf_sizes: Tuple[int, ...], density: float, p: int,
               codec_name: str, schedule: Optional[str], alpha_ms: float,
               beta_gbps: float, mode: str):
    """dp[b][i] = the least (cost ms, largest bucket) of cutting the first
    i leaves into exactly b buckets, arg[b][i] the cut realizing it, and
    seg(j, i) a bucket of leaves j..i-1's (cost, size)."""
    L = len(leaf_sizes)
    prefix = [0]
    for s in leaf_sizes:
        prefix.append(prefix[-1] + s)

    @functools.lru_cache(maxsize=None)
    def seg(j: int, i: int) -> Tuple[float, int]:
        n_b = prefix[i] - prefix[j]
        k_b = k_for_density(n_b, density)
        return (bucket_cost_ms(n_b, k_b, p=p, codec=codec_name,
                               schedule=schedule, alpha_ms=alpha_ms,
                               beta_gbps=beta_gbps, mode=mode), n_b)

    INF = (math.inf, 0)
    dp: List[List[Tuple[float, int]]] = [[INF] * (L + 1)
                                         for _ in range(L + 1)]
    arg: List[List[int]] = [[-1] * (L + 1) for _ in range(L + 1)]
    dp[0][0] = (0.0, 0)
    for b in range(1, L + 1):
        for i in range(b, L + 1):
            best, best_j = INF, -1
            for j in range(b - 1, i):
                prev = dp[b - 1][j]
                if prev[0] == math.inf:
                    continue
                c, load = seg(j, i)
                cand = (prev[0] + c, max(prev[1], load))
                if cand < best:  # strict: the earliest cut wins ties
                    best, best_j = cand, j
            dp[b][i] = best
            arg[b][i] = best_j
    return dp, arg, seg


def _backtrack(arg, b: int, L: int) -> Tuple[int, ...]:
    cuts = [L]
    i = L
    for bb in range(b, 0, -1):
        i = arg[bb][i]
        cuts.append(i)
    return tuple(reversed(cuts))


def optimal_boundaries(leaf_sizes: Sequence[int], density: float, *,
                       n_buckets: Optional[int], p: int, codec="fp32",
                       schedule: Optional[str] = None, alpha_ms: float,
                       beta_gbps: float,
                       mode: str = "gtopk_layerwise") -> Tuple[int, ...]:
    """The cost-least contiguous partition into `n_buckets` buckets (at
    most L), or into any number when it is None (a larger B wins ties)."""
    sizes = tuple(int(s) for s in leaf_sizes)
    L = len(sizes)
    if L == 0:
        raise ValueError("cannot bucket zero leaves")
    codec_name = getattr(codec, "name", codec)
    dp, arg, _ = _dp_tables(sizes, float(density), int(p), str(codec_name),
                            schedule, float(alpha_ms), float(beta_gbps),
                            mode)
    if n_buckets is not None:
        return _backtrack(arg, max(1, min(int(n_buckets), L)), L)
    best_b, best = L, dp[L][L]
    for b in range(L - 1, 0, -1):
        if dp[b][L] < best:
            best_b, best = b, dp[b][L]
    return _backtrack(arg, best_b, L)


def plan_buckets(leaf_sizes: Sequence[int], density: float, *,
                 buckets=BUCKETS_DEFAULT, p: int = 1, codec="fp32",
                 schedule: Optional[str] = None,
                 alpha_ms: Optional[float] = None,
                 beta_gbps: Optional[float] = None,
                 fit_path: Optional[str] = None,
                 mode: str = "gtopk_layerwise") -> Optional[BucketPlan]:
    """The ``BucketPlan`` of a ``--buckets`` spec over `leaf_sizes`, or
    None for 'concat'. 'leaf' is pure structure; an int B or 'auto' is
    priced with `alpha_ms` and `beta_gbps`, or else with the planner's
    fit (``planner.planner_inputs(fit_path)``); at P = 1 no merge costs
    anything and no fit is read."""
    spec = parse_buckets(buckets)
    if spec == "concat":
        return None
    sizes = tuple(int(s) for s in leaf_sizes)
    L = len(sizes)
    if L == 0:
        raise ValueError("cannot bucket zero leaves")

    def per_bucket_ks(bounds: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(k_for_density(sum(sizes[lo:hi]), density)
                     for lo, hi in zip(bounds, bounds[1:]))

    if spec == "leaf":
        bounds = tuple(range(L + 1))
        return BucketPlan(bounds, sizes, per_bucket_ks(bounds), spec="leaf")
    if p <= 1:
        alpha_ms, beta_gbps = 0.0, 1.0  # every merge costs 0 at P = 1
    elif alpha_ms is None or beta_gbps is None:
        from gtopkssgd_tpu_torch.parallel.planner import planner_inputs
        inputs = planner_inputs(fit_path)
        alpha_ms = inputs["alpha_ms"] if alpha_ms is None else alpha_ms
        beta_gbps = inputs["beta_gbps"] if beta_gbps is None else beta_gbps
    bounds = optimal_boundaries(
        sizes, density, n_buckets=None if spec == "auto" else int(spec),
        p=p, codec=codec, schedule=schedule, alpha_ms=alpha_ms,
        beta_gbps=beta_gbps, mode=mode)
    return BucketPlan(bounds, sizes, per_bucket_ks(bounds),
                      spec=buckets_key(spec))
