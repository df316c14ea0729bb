"""Byte-balanced buckets of the layer-wise wire (``--buckets``) and their
execution order (``--pipeline``).

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
``auto`` (the DP picks B too).

Execution order (``--pipeline``, ``modes.PIPELINES``): under ``serial`` a
step pays sum_b (T_select_b + T_merge_b); under ``overlap`` bucket b+1
selects while bucket b's merge is in flight, and the exposed span is

    T_select_1 + sum_{j=2..B} max(T_select_j, T_merge_{j-1}) + T_merge_B

(``pipeline_span_ms``). That span is not additive over buckets, so the DP
priced under ``overlap`` minimizes the per-stage surrogate sum_b
max(T_select_b, T_merge_b) (``stage_cost_ms``); ``auto`` solves the DP
under both orders and keeps the one whose true span is smaller, ``serial``
on ties. Selection is priced linearly, T_select = gamma * n / 1e6 ms
(``select_cost_ms``), so under ``serial`` it is the same for every
partition and the serial objective is the merge cost alone.

gamma is a measurement of the card: ``select_probe`` times the port's own
selection stage for each method and writes the fit beside this module
(``select_fit.json``, by device and method); ``load_select_gamma`` reads
it and raises for a device or method it does not hold. The pricing functions
take gamma as an argument, never a default.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import List, Optional, Sequence, Tuple

import torch

from gtopkssgd_tpu_torch.ops.topk import k_for_density
from gtopkssgd_tpu_torch.parallel.collectives import (
    comm_bytes_per_step,
    tree_rounds,
)

BUCKETS_DEFAULT = "concat"
_WORD_SPECS = ("concat", "leaf", "auto")
PIPELINE_DEFAULT = "serial"
_PIPELINE_SPECS = ("serial", "overlap", "auto")

_HERE = os.path.dirname(os.path.abspath(__file__))
#: The selection-cost fit ``select_probe`` measured on the card.
SELECT_FIT = os.path.join(_HERE, "select_fit.json")
SELECT_PROBE = "python -m gtopkssgd_tpu_torch.select_probe"


def device_kind(device) -> str:
    """The name a selection fit is keyed by: the CUDA card's name, or the
    device type ('cpu')."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def find_select_gamma(device: str, method: str,
                      fit_path: Optional[str] = None) -> Optional[float]:
    """gamma (ms per 1e6 elements) of `method`'s selection stage on
    `device` (a ``device_kind``), from `fit_path` or the committed fit;
    None when the file holds no entry for them."""
    path = fit_path or SELECT_FIT
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        entries = json.load(fh).get("fits", [])
    for e in entries:
        if e.get("device") == device and e.get("method") == method:
            return float(e["gamma_ms_per_melem"])
    return None


def load_select_gamma(device: str, method: str,
                      fit_path: Optional[str] = None) -> float:
    """``find_select_gamma``, raising ValueError (naming the probe) where
    there is no entry."""
    gamma = find_select_gamma(device, method, fit_path)
    if gamma is None:
        raise ValueError(
            f"no selection-cost fit for method {method!r} on {device!r} in "
            f"{fit_path or SELECT_FIT}: measure one on that device with "
            f"{SELECT_PROBE}, or pass select_gamma to the optimizer")
    return gamma


def parse_pipeline(spec) -> str:
    """'serial' | 'overlap' | 'auto'; ValueError on anything else."""
    if isinstance(spec, str):
        word = spec.strip().lower()
        if word in _PIPELINE_SPECS:
            return word
    raise ValueError(
        f"invalid --pipeline spec {spec!r}; grammar: serial | overlap | auto")


def _gamma(select_gamma: Optional[float]) -> float:
    if select_gamma is None:
        raise ValueError(
            "pricing the selection needs its cost: pass select_gamma (ms "
            f"per 1e6 elements), measured with {SELECT_PROBE}")
    return float(select_gamma)


def select_cost_ms(n_elems: int, select_gamma: float) -> float:
    """Modeled ms of one bucket's selection over n_elems: gamma * n / 1e6,
    linear in n by design."""
    return _gamma(select_gamma) * float(n_elems) / 1e6


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
    k; ``pipeline`` the resolved execution order (never 'auto')."""

    boundaries: Tuple[int, ...]
    leaf_sizes: Tuple[int, ...]
    ks: Tuple[int, ...]
    spec: str = "auto"
    pipeline: str = PIPELINE_DEFAULT

    def __post_init__(self):
        L = len(self.leaf_sizes)
        b = self.boundaries
        if (len(b) < 2 or b[0] != 0 or b[-1] != L
                or any(b[i] >= b[i + 1] for i in range(len(b) - 1))):
            raise ValueError(
                f"boundaries {b} is not a partition of {L} leaves")
        if len(self.ks) != len(b) - 1:
            raise ValueError(f"{len(self.ks)} ks for {len(b) - 1} buckets")
        if self.pipeline not in ("serial", "overlap"):
            raise ValueError(
                f"BucketPlan.pipeline must be a resolved execution order "
                f"(serial|overlap), got {self.pipeline!r}")

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
            "pipeline": self.pipeline,
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
            pipeline=str(manifest.get("pipeline", PIPELINE_DEFAULT)),
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


def stage_cost_ms(n_b: int, k_b: int, *, pipeline: str = PIPELINE_DEFAULT,
                  p: int, codec="fp32", schedule: Optional[str] = None,
                  alpha_ms: float, beta_gbps: float,
                  mode: str = "gtopk_layerwise",
                  select_gamma: Optional[float] = None) -> float:
    """The DP's term for one bucket: its merge cost under 'serial' (the
    selection costs the same for every partition there), max(T_select,
    T_merge) under 'overlap'."""
    merge = bucket_cost_ms(n_b, k_b, p=p, codec=codec, schedule=schedule,
                           alpha_ms=alpha_ms, beta_gbps=beta_gbps, mode=mode)
    if pipeline == "overlap":
        return max(select_cost_ms(n_b, select_gamma), merge)
    return merge


def partition_cost_ms(plan: BucketPlan, *, p: int, codec="fp32",
                      schedule: Optional[str] = None, alpha_ms: float,
                      beta_gbps: float, mode: str = "gtopk_layerwise",
                      pipeline: str = PIPELINE_DEFAULT,
                      select_gamma: Optional[float] = None) -> float:
    """The DP's objective for `plan` under `pipeline`: its buckets' stage
    costs, summed."""
    return sum(stage_cost_ms(n_b, k_b, pipeline=pipeline, p=p, codec=codec,
                             schedule=schedule, alpha_ms=alpha_ms,
                             beta_gbps=beta_gbps, mode=mode,
                             select_gamma=select_gamma)
               for n_b, k_b in plan.pairs())


def pipeline_span_ms(plan: BucketPlan, *, p: int, codec="fp32",
                     schedule: Optional[str] = None, alpha_ms: float,
                     beta_gbps: float, select_gamma: float,
                     mode: str = "gtopk_layerwise",
                     pipeline: Optional[str] = None) -> float:
    """The modeled span of a step's select and merge chain under
    `pipeline` (default: the plan's own): sum_b (T_select_b + T_merge_b)
    under 'serial'; under 'overlap' the first selection, then each
    selection against the previous merge, then the last merge."""
    pipe = plan.pipeline if pipeline is None else pipeline
    sel = [select_cost_ms(n_b, select_gamma) for n_b in plan.sizes]
    merge = [bucket_cost_ms(n_b, k_b, p=p, codec=codec, schedule=schedule,
                            alpha_ms=alpha_ms, beta_gbps=beta_gbps,
                            mode=mode)
             for n_b, k_b in plan.pairs()]
    if pipe != "overlap":
        return sum(sel) + sum(merge)
    span = sel[0]
    for j in range(1, len(sel)):
        span += max(sel[j], merge[j - 1])
    return span + merge[-1]


@functools.lru_cache(maxsize=64)
def _dp_tables(leaf_sizes: Tuple[int, ...], density: float, p: int,
               codec_name: str, schedule: Optional[str], alpha_ms: float,
               beta_gbps: float, mode: str, pipeline: str,
               select_gamma: Optional[float]):
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
        return (stage_cost_ms(n_b, k_b, pipeline=pipeline, p=p,
                              codec=codec_name, schedule=schedule,
                              alpha_ms=alpha_ms, beta_gbps=beta_gbps,
                              mode=mode, select_gamma=select_gamma), n_b)

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
                       beta_gbps: float, mode: str = "gtopk_layerwise",
                       pipeline: str = PIPELINE_DEFAULT,
                       select_gamma: Optional[float] = None
                       ) -> Tuple[int, ...]:
    """The least-cost contiguous partition under `pipeline`'s pricing into
    `n_buckets` buckets (at most L), or into any number when it is None
    (a larger B wins ties)."""
    sizes = tuple(int(s) for s in leaf_sizes)
    L = len(sizes)
    if L == 0:
        raise ValueError("cannot bucket zero leaves")
    # Only the overlap pricing reads gamma.
    select_gamma = _gamma(select_gamma) if pipeline == "overlap" else None
    codec_name = getattr(codec, "name", codec)
    dp, arg, _ = _dp_tables(sizes, float(density), int(p), str(codec_name),
                            schedule, float(alpha_ms), float(beta_gbps),
                            mode, str(pipeline), select_gamma)
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
                 mode: str = "gtopk_layerwise",
                 pipeline: str = PIPELINE_DEFAULT,
                 select_gamma: Optional[float] = None
                 ) -> Optional[BucketPlan]:
    """The ``BucketPlan`` of a ``--buckets`` spec over `leaf_sizes`, or
    None for 'concat'. 'leaf' is pure structure; an int B or 'auto' is
    priced with `alpha_ms` and `beta_gbps`, or else with the planner's
    fit (``planner.planner_inputs(fit_path)``); at P = 1 no merge costs
    anything and no fit is read. `pipeline` 'serial' or 'overlap' is
    pinned (the DP prices under it); 'auto' solves under both and keeps
    the plan with the smaller ``pipeline_span_ms``, 'serial' on ties.
    Pricing a selection (an 'overlap' DP, or 'auto') needs
    `select_gamma`."""
    spec = parse_buckets(buckets)
    if spec == "concat":
        return None
    pipe = parse_pipeline(pipeline)
    sizes = tuple(int(s) for s in leaf_sizes)
    L = len(sizes)
    if L == 0:
        raise ValueError("cannot bucket zero leaves")
    if pipe == "auto" or (pipe == "overlap" and spec != "leaf"):
        select_gamma = _gamma(select_gamma)

    def per_bucket_ks(bounds: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(k_for_density(sum(sizes[lo:hi]), density)
                     for lo, hi in zip(bounds, bounds[1:]))

    if spec != "leaf" or pipe == "auto":
        if p <= 1:
            alpha_ms, beta_gbps = 0.0, 1.0  # every merge costs 0 at P = 1
        elif alpha_ms is None or beta_gbps is None:
            from gtopkssgd_tpu_torch.parallel.planner import planner_inputs
            inputs = planner_inputs(fit_path)
            alpha_ms = inputs["alpha_ms"] if alpha_ms is None else alpha_ms
            beta_gbps = inputs["beta_gbps"] if beta_gbps is None else beta_gbps

    def span(plan: BucketPlan) -> float:
        return pipeline_span_ms(plan, p=p, codec=codec, schedule=schedule,
                                alpha_ms=alpha_ms, beta_gbps=beta_gbps,
                                select_gamma=select_gamma, mode=mode)

    if spec == "leaf":
        bounds = tuple(range(L + 1))
        plans = [BucketPlan(bounds, sizes, per_bucket_ks(bounds),
                            spec="leaf", pipeline=pp)
                 for pp in (("serial", "overlap") if pipe == "auto"
                            else (pipe,))]
        return min(plans, key=span) if len(plans) > 1 else plans[0]

    def solve(pp: str) -> BucketPlan:
        bounds = optimal_boundaries(
            sizes, density, n_buckets=None if spec == "auto" else int(spec),
            p=p, codec=codec, schedule=schedule, alpha_ms=alpha_ms,
            beta_gbps=beta_gbps, mode=mode, pipeline=pp,
            select_gamma=select_gamma)
        return BucketPlan(bounds, sizes, per_bucket_ks(bounds),
                          spec=buckets_key(spec), pipeline=pp)

    if pipe != "auto":
        return solve(pipe)
    # min() keeps the first on ties: 'serial'.
    return min((solve("serial"), solve("overlap")), key=span)


def describe(plan: BucketPlan, *, p: int, codec="fp32",
             schedule: Optional[str] = None, alpha_ms: float,
             beta_gbps: float, select_gamma: float,
             mode: str = "gtopk_layerwise") -> List[dict]:
    """One row a bucket: leaf range, elements, wire k, modeled bytes, and
    the modeled ms of its merge, its selection and the stage term the DP
    priced under the plan's order."""
    rows = []
    for b, (n_b, k_b) in enumerate(plan.pairs()):
        lo, hi = plan.leaf_range(b)
        merge_ms = bucket_cost_ms(
            n_b, k_b, p=p, codec=codec, schedule=schedule,
            alpha_ms=alpha_ms, beta_gbps=beta_gbps, mode=mode)
        select_ms = select_cost_ms(n_b, select_gamma)
        rows.append({
            "bucket": b,
            "leaves": f"{lo}:{hi}",
            "n_leaves": hi - lo,
            "elems": n_b,
            "k": k_b,
            "wire_bytes": comm_bytes_per_step(
                mode, n_b, k_b, p, codec=getattr(codec, "name", codec),
                schedule=schedule),
            "modeled_ms": merge_ms,
            "select_ms": select_ms,
            "stage_ms": (max(select_ms, merge_ms)
                         if plan.pipeline == "overlap" else merge_ms),
        })
    return rows
