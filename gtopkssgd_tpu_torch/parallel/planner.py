"""The comm planner: which wire realizes a mode, scored once at start-up.

Counterpart of ``gtopkssgd_tpu/parallel/planner.py``. A mode fixes what
set is applied and the repair contract; a ``CommPlan`` fixes the wire --
the schedule, the in-slice phase, the codec, the slice width, the
bucketing and the buckets' execution order. ``build_decision`` scores
every plan
that realizes the mode with the alpha-beta model of
``parallel.comm_model`` and keeps the cheapest; the historical schedule
(``modes.default_schedule``) comes first and wins ties. A pin
(``--comm-plan``) names a plan instead. Only the gtopk family has a
choice, the hypercube ``tree`` or the Ok-Topk ``balanced`` schedule; the
planner never swaps a mode for another.

The constants come from ``comm_model.load_fit``: the fit the port
measured on the card, or a file given as ``fit_path``; explicit
arguments override them. Each candidate's record also holds the span of
the step's select and merge chain under either execution order
(``bucketing.pipeline_span_ms``), priced with the selection cost the
caller passes (``bucketing.select_gamma`` reads the card's fit); without
one the spans are None, not measured.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from gtopkssgd_tpu_torch.modes import (
    ALLGATHER_MODES,
    DENSE_MODES,
    GTOPK_MODES,
    HIER_MODES,
    LAYERWISE_MODES,
    default_schedule,
)
from gtopkssgd_tpu_torch.parallel import bucketing as _bucketing
from gtopkssgd_tpu_torch.parallel import comm_model
from gtopkssgd_tpu_torch.parallel.collectives import comm_bytes_per_step


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """One wire realization of a mode: ``schedule`` (modes.SCHEDULES)
    across ranks or slices, ``intra`` the in-slice phase ('psum' for the
    hierarchical mode, 'none' otherwise), the sparse ``codec``, the slice
    width ``ici_size``, the layer-wise ``bucketing``
    (``bucketing.buckets_key``) and the resolved execution order of its
    buckets, ``pipeline`` (``modes.PIPELINES``; ``plan_buckets`` resolves
    'auto'). ``name`` is what ``--comm-plan`` pins."""

    name: str
    mode: str
    schedule: str
    intra: str = "none"
    codec: str = "fp32"
    ici_size: int = 1
    bucketing: str = "concat"
    pipeline: str = "serial"

    @property
    def wire_mode(self) -> str:
        """The comm model's key this plan prices as."""
        return comm_model.wire_mode_for(self.mode, self.schedule)


def _norm_mode(mode: Optional[str]) -> str:
    return "dense" if mode in DENSE_MODES else str(mode)


def candidate_plans(mode: Optional[str], *, codec: str = "fp32",
                    ici_size: int = 1, bucketing: str = "concat",
                    pipeline: str = "serial") -> Tuple[CommPlan, ...]:
    """Every plan that realizes `mode`, the historical one first; the
    gtopk family's carry `bucketing` and `pipeline`."""
    m = _norm_mode(mode)
    if m in DENSE_MODES:
        return (CommPlan("dense", m, "psum", "none", codec, 1),)
    if m in ALLGATHER_MODES:
        return (CommPlan("allgather", m, "allgather", "none", codec, 1),)
    if m in HIER_MODES:
        return (CommPlan("hier", m, "tree", "psum", codec,
                         max(1, ici_size)),)
    if m in GTOPK_MODES or m in LAYERWISE_MODES:
        return (CommPlan("tree", m, "tree", "none", codec, 1, bucketing,
                         pipeline),
                CommPlan("balanced", m, "balanced", "none", codec, 1,
                         bucketing, pipeline))
    raise ValueError(f"unknown mode {mode!r}")


def validate_pin(pin: Optional[str], mode: Optional[str], *,
                 ici_size: int = 1) -> str:
    """A ``--comm-plan`` pin, normalized ('auto' for None or ''), checked
    against the plans that realize `mode`."""
    pin = "auto" if pin in (None, "", "auto") else str(pin)
    if pin == "auto":
        return pin
    names = [c.name for c in candidate_plans(mode, ici_size=ici_size)]
    if pin not in names:
        raise ValueError(
            f"--comm-plan {pin!r} does not realize mode {mode!r}; "
            f"valid plans here: auto, {', '.join(names)}")
    return pin


def planner_inputs(fit_path: Optional[str] = None) -> Dict[str, Any]:
    """The constants the planner scores with and where they came from:
    the fit's alpha and beta, and the same beta for the in-slice link
    (one link class measured)."""
    fit = comm_model.load_fit(fit_path)
    return {"alpha_ms": fit["alpha_ms"], "beta_gbps": fit["beta_gbps"],
            "ici_gbps": fit["beta_gbps"], "fit_source": fit["source"]}


def score_plan(plan: CommPlan, p: int, *, n: int, k: int, alpha_ms: float,
               beta_gbps: float, ici_gbps: float,
               buckets: Optional[Tuple[Tuple[int, int], ...]] = None
               ) -> float:
    """Predicted comm ms of one plan; ``buckets`` prices B merges."""
    return comm_model.predict_comm_ms(
        plan.wire_mode, p, n=n, k=k, alpha_ms=alpha_ms,
        beta_gbps=beta_gbps, ici_gbps=ici_gbps, ici_size=plan.ici_size,
        codec=plan.codec, buckets=buckets)


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """The chosen plan, every candidate's score and the model's inputs.
    ``record()`` is the flat dict a run prints once."""

    plan: CommPlan
    candidates: Tuple[Dict[str, Any], ...]
    inputs: Dict[str, Any]
    pin: str = "auto"

    def record(self) -> Dict[str, Any]:
        historical = default_schedule(self.plan.mode)
        return {
            "plan": self.plan.name,
            "schedule": self.plan.schedule,
            "wire_mode": self.plan.wire_mode,
            "mode": self.plan.mode,
            "intra": self.plan.intra,
            "bucketing": self.plan.bucketing,
            "pipeline": self.plan.pipeline,
            "pin": self.pin,
            "plan_is_default": float(self.plan.schedule == historical),
            "candidates": list(self.candidates),
            **{key: self.inputs[key] for key in sorted(self.inputs)},
        }


def build_decision(mode: Optional[str], *, p: int, n: int, k: int,
                   codec: str = "fp32", ici_size: int = 1,
                   pin: Optional[str] = "auto",
                   fit_path: Optional[str] = None,
                   alpha_ms: Optional[float] = None,
                   beta_gbps: Optional[float] = None,
                   ici_gbps: Optional[float] = None,
                   bucketing: str = "concat",
                   buckets: Optional[Tuple[Tuple[int, int], ...]] = None,
                   fit_source: Optional[str] = None,
                   pipeline: str = "serial",
                   select_gamma: Optional[float] = None) -> PlanDecision:
    """Score every plan for (mode, P, n, k, codec) and pick the pinned one,
    or else the cheapest (the first on ties). Explicit alpha, beta and
    in-slice bandwidth override the fit (all three given: no fit is
    read); ``fit_source`` labels such an override. ``buckets`` (the
    ``BucketPlan``'s (n_b, k_b) pairs) prices the bucketed wire;
    ``pipeline`` is the resolved execution order the plan carries. Each
    candidate records its comm ms, its wire bytes a rank a step and
    ``span_serial_ms`` / ``span_overlap_ms``, the span of the select and
    merge chain under each order with selection cost `select_gamma` (an
    unbucketed wire is one bucket of (n, k)); None without a gamma."""
    pin = validate_pin(pin, mode, ici_size=ici_size)
    explicit = (alpha_ms, beta_gbps, ici_gbps)
    if all(x is not None for x in explicit):
        inputs: Dict[str, Any] = {"fit_source": fit_source or "arg"}
    else:
        inputs = planner_inputs(fit_path)
    source = fit_source if fit_source is not None else "arg"
    if alpha_ms is not None:
        inputs["alpha_ms"] = float(alpha_ms)
        inputs["fit_source"] = source
    if beta_gbps is not None:
        inputs["beta_gbps"] = float(beta_gbps)
        inputs["fit_source"] = source
    if ici_gbps is not None:
        inputs["ici_gbps"] = float(ici_gbps)
    cands = candidate_plans(mode, codec=codec, ici_size=ici_size,
                            bucketing=bucketing, pipeline=pipeline)
    pairs = buckets if buckets else ((n, k),)
    span_plan = _bucketing.BucketPlan(
        boundaries=tuple(range(len(pairs) + 1)),
        leaf_sizes=tuple(nb for nb, _ in pairs),
        ks=tuple(kb for _, kb in pairs))
    scored: List[Dict[str, Any]] = []
    for cand in cands:
        ms = score_plan(cand, p, n=n, k=k, alpha_ms=inputs["alpha_ms"],
                        beta_gbps=inputs["beta_gbps"],
                        ici_gbps=inputs["ici_gbps"], buckets=buckets)
        wire_bytes = sum(
            comm_bytes_per_step(cand.mode, n_b, k_b, p,
                                ici_size=cand.ici_size, codec=cand.codec,
                                schedule=cand.schedule)
            for n_b, k_b in pairs)
        spans = {pipe: None if select_gamma is None else round(
            _bucketing.pipeline_span_ms(
                span_plan, p=p, codec=cand.codec, schedule=cand.schedule,
                alpha_ms=inputs["alpha_ms"], beta_gbps=inputs["beta_gbps"],
                select_gamma=select_gamma, mode=cand.mode, pipeline=pipe), 6)
            for pipe in ("serial", "overlap")}
        scored.append({
            "name": cand.name, "schedule": cand.schedule,
            "wire_mode": cand.wire_mode, "comm_ms": round(ms, 6),
            "wire_bytes": wire_bytes,
            "span_serial_ms": spans["serial"],
            "span_overlap_ms": spans["overlap"],
        })
    if pin != "auto":
        chosen = next(c for c in cands if c.name == pin)
    else:
        chosen = cands[min(range(len(cands)),
                           key=lambda i: scored[i]["comm_ms"])]
    inputs = {**inputs, "p": p, "n": n, "k": k, "codec": str(codec),
              "ici_size": ici_size}
    return PlanDecision(plan=chosen, candidates=tuple(scored),
                        inputs=inputs, pin=pin)

