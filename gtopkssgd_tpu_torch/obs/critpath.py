"""The distributed critical path, the port of ``gtopkssgd_tpu/obs/
critpath.py``: per-step (rank, stage) attribution.

  wait split -- the comm class's wall-clock union on one rank is split
      into a modeled-wire prefix and a trailing ``wait`` remainder: the
      ledger's alpha-beta model (``obs.ledger``, the planner's
      ``parallel.comm_model``) prices the bytes the step moved, and the
      span the collective took beyond that is waiting for a skewed peer,
      not wire. Each interval of the union is cut at the same wire
      fraction. Under gloo the comm union is the host's (the c10d calls
      and gloo's ranges, ``obs.trace_attr``), so the wait is host time.

  stage segments -- a compact per-step record of ordered
      ``{stage, t0_us, t1_us}`` intervals over STAGES = (compute, select,
      comm, wait), rank-relative (earliest t0 == 0), logged as the durable
      ``critpath`` kind, one a captured dispatch.

  critical path -- a deterministic backward walk over the per-rank
      segment sets of one step: start from the rank that defines the
      step's wall and walk toward 0, preferring busy (non-wait) segments
      and handing off to a busy rank whenever the current one only
      waits. ``crit_frac`` (chain length / wall) says how much of the step
      the walk explains; profiler gaps lower it.

All tie-breaks are deterministic (lowest rank, then STAGES order), so
fixtures can assert exact chains. Pure host arithmetic: no torch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from gtopkssgd_tpu_torch.obs import ledger, trace_attr

# Stage universe, in tie-break order: when two stages tie on chain (or
# local-budget) time, the earlier one here wins. ``wait`` is last so a
# tie never blames skew over real work.
STAGES = ("compute", "select", "comm", "wait")

_EPS = 1e-6


# ------------------------------------------------------------ wait split

def wait_split(comm_iv: Sequence[Tuple[float, float]],
               wire_us: float
               ) -> Tuple[List[Tuple[float, float]],
                          List[Tuple[float, float]]]:
    """Split the comm wall-clock union into (wire, wait) interval lists.

    ``wire_us`` is the ledger-modeled wire time for the bytes this step
    moved; the comm union's first ``wire_us`` worth of span (allocated
    proportionally per union interval) stays ``comm``, the trailing
    remainder becomes ``wait``. wire_us >= union length means no wait
    (the model already explains the whole span); wire_us <= 0 means the
    whole span is wait (nothing was supposed to be on the wire)."""
    union = trace_attr._interval_union(list(comm_iv))
    total = sum(e - s for s, e in union)
    if total <= 0:
        return [], []
    wire_frac = min(1.0, max(0.0, float(wire_us) / total))
    wire: List[Tuple[float, float]] = []
    wait: List[Tuple[float, float]] = []
    for s, e in union:
        cut = s + (e - s) * wire_frac
        if cut - s > _EPS:
            wire.append((s, cut))
        if e - cut > _EPS:
            wait.append((cut, e))
    return wire, wait


def stage_segments(iv_by_class: Mapping[str, Sequence[Tuple[float, float]]],
                   wire_us: float,
                   normalize: bool = True,
                   fill_gaps: bool = False) -> List[Dict[str, Any]]:
    """Ordered ``{stage, t0_us, t1_us}`` segments from per-class raw
    wall intervals (trace_attr's ``op_iv``/``span_iv`` shape). compute
    and select are their interval unions; comm is wait-split against
    ``wire_us``. ``normalize`` shifts the earliest t0 to 0 so records
    are rank-relative and joinable across hosts with unsynced clocks.

    ``fill_gaps`` is for REAL profiler captures, where op events never
    tile the dispatch window (scheduler gaps between op executions are
    framework overhead, not a distinct stage): each uncovered gap is
    absorbed into the stage that PRECEDES it — work that stage had not
    yet retired, or a wait the collective had not yet released — and
    adjacent same-stage segments are then coalesced, so the record is
    compact (one segment per stage transition) and the segments tile
    the measured step wall. Synthetic/fixture segments keep the default
    (gaps stay visible and lower ``crit_frac`` honestly)."""
    raw: List[Tuple[float, str, float]] = []  # (t0, stage, t1)
    for stage in ("compute", "select"):
        for s, e in trace_attr._interval_union(
                list(iv_by_class.get(stage, ()))):
            raw.append((s, stage, e))
    wire, wait = wait_split(iv_by_class.get("comm", ()), wire_us)
    for s, e in wire:
        raw.append((s, "comm", e))
    for s, e in wait:
        raw.append((s, "wait", e))
    if not raw:
        return []
    t_min = min(s for s, _, _ in raw) if normalize else 0.0
    segs = [{"stage": stage,
             "t0_us": round(s - t_min, 1),
             "t1_us": round(e - t_min, 1)}
            for s, stage, e in raw]
    segs.sort(key=lambda g: (g["t0_us"], g["t1_us"],
                             STAGES.index(g["stage"])))
    if not fill_gaps:
        return segs
    out: List[Dict[str, Any]] = []
    last = -1  # index of the segment holding the latest end so far
    for seg in segs:
        if out and seg["t0_us"] > out[last]["t1_us"] + _EPS:
            # Uncovered gap: the stage that ran latest owns it.
            out[last]["t1_us"] = seg["t0_us"]
        if (out and out[last]["stage"] == seg["stage"]
                and seg["t0_us"] <= out[last]["t1_us"] + _EPS):
            out[last]["t1_us"] = max(out[last]["t1_us"], seg["t1_us"])
        else:
            out.append(seg)
            if last < 0 or seg["t1_us"] >= out[last]["t1_us"]:
                last = len(out) - 1
    return out


def coarsen(segments: Sequence[Mapping[str, Any]],
            min_us: float) -> List[Dict[str, Any]]:
    """Compact a (filled) segment list for the durable record: absorb
    segments shorter than ``min_us`` into their predecessor and merge
    same-stage neighbors, leaving one segment per sustained stage
    transition. Micro-flicker (op-granularity interleave of classes on
    a real trace) changes owner here, so per-stage TOTALS must be
    computed from the fine list (``build_record(..., totals=...)``) —
    the coarse list is the chain-walk/timeline view, not the budget."""
    out: List[Dict[str, Any]] = []
    for seg in segments:
        seg = dict(seg)
        if out and (seg["stage"] == out[-1]["stage"]
                    or float(seg["t1_us"]) - float(seg["t0_us"])
                    < float(min_us)):
            out[-1]["t1_us"] = max(out[-1]["t1_us"], seg["t1_us"])
        else:
            out.append(seg)
    return out


def stage_totals(segments: Sequence[Mapping[str, Any]]
                 ) -> Dict[str, float]:
    """Per-stage summed lengths (µs) of a segment list."""
    tot = {s: 0.0 for s in STAGES}
    for seg in segments:
        st = seg.get("stage")
        if st in tot:
            tot[st] += float(seg["t1_us"]) - float(seg["t0_us"])
    return tot


def dominant_stage(stage_us: Mapping[str, float]) -> Optional[str]:
    """Stage with the largest total; STAGES order breaks ties; None
    when everything is zero."""
    best, best_us = None, 0.0
    for s in STAGES:
        us = float(stage_us.get(s, 0.0))
        if us > best_us + _EPS:
            best, best_us = s, us
    return best


# ------------------------------------------------------- record building

def build_record(segments: Sequence[Mapping[str, Any]],
                 step: Optional[int] = None,
                 totals: Optional[Mapping[str, float]] = None
                 ) -> Dict[str, Any]:
    """The flat per-rank ``critpath`` record (no 'kind' key — callers
    log it as kind="critpath"): segment list + per-stage totals +
    wall/wait summary. ``wait_frac`` is wait over this rank's wall —
    the share of the step this rank spent blocked at collectives.
    ``step`` may be stamped later by the caller (trace_attr doesn't
    know it at attribution time). Pass ``totals`` (stage_totals of the
    FINE segment list) when ``segments`` has been coarsened — the
    coarse view reassigns micro-flicker and must not skew the budget."""
    segs = [dict(s) for s in segments]
    totals = dict(totals) if totals is not None else stage_totals(segs)
    totals = {s: float(totals.get(s, 0.0)) for s in STAGES}
    wall = max((float(s["t1_us"]) for s in segs), default=0.0)
    wait_us = totals["wait"]
    rec = {} if step is None else {"step": step}
    return {
        **rec,
        "wall_us": round(wall, 1),
        "t_compute_us": round(totals["compute"], 1),
        "t_select_us": round(totals["select"], 1),
        "t_comm_wire_us": round(totals["comm"], 1),
        "t_wait_us": round(wait_us, 1),
        "wait_frac": round(wait_us / wall, 6) if wall > 0 else 0.0,
        "crit_stage": dominant_stage(totals),
        "segments": segs,
    }


def modeled_wire_us(manifest: Optional[Mapping[str, Any]],
                    probe_dir: Optional[str] = None,
                    nprocs: Optional[int] = None,
                    backend: Optional[str] = None,
                    fit: Optional[Mapping[str, Any]] = None
                    ) -> Optional[float]:
    """The ledger-modeled wire time a step, in us, for this run's bytes:
    the wait split's budget. Reads the run manifest the trainer prices
    with (``utils.manifest`` plus the plan's schedule and the buckets),
    `fit` or the one ``ledger.load_alpha_beta`` finds (a ``calib_fit`` in
    `probe_dir`, else the committed card fit for `backend` or the
    manifest's), and prices with ``ledger.predict_comm_ms``, so the split
    and the ledger never disagree on the model. None when the manifest
    cannot parameterize the model or no fit is found."""
    params = ledger._manifest_params(manifest)
    if params is None:
        return None
    fit = fit or ledger.load_alpha_beta(
        search_dir=probe_dir, nprocs=nprocs,
        backend=backend or (manifest or {}).get("backend") or "gloo")
    if fit is None:
        return None
    wm = ledger.wire_mode_for(params["mode"], params.get("schedule"),
                              bucketing=params.get("bucketing"))
    ms = ledger.predict_comm_ms(
        wm, params["p"], n=params["n"], k=params["k"],
        alpha_ms=fit["alpha_ms"], beta_gbps=fit["beta_gbps"],
        codec=params["codec"], buckets=params.get("buckets"))
    return ms * 1e3


# ------------------------------------------------------- critical path

def _covering(segs: Sequence[Mapping[str, Any]], t: float
              ) -> List[Mapping[str, Any]]:
    """Segments covering the instant just before ``t``."""
    return [s for s in segs
            if float(s["t0_us"]) < t - _EPS
            and float(s["t1_us"]) >= t - _EPS]


def _pick_busy(cands: Sequence[Mapping[str, Any]]
               ) -> Optional[Mapping[str, Any]]:
    """Latest-starting non-wait segment, tie-break STAGES order."""
    busy = [s for s in cands if s.get("stage") != "wait"]
    if not busy:
        return None
    return max(busy, key=lambda s: (float(s["t0_us"]),
                                    -STAGES.index(s["stage"])))


def critical_path(segs_by_rank: Mapping[int, Sequence[Mapping[str, Any]]]
                  ) -> Dict[str, Any]:
    """The step-bounding chain of (rank, stage) segments.

    ``segs_by_rank`` maps rank → that rank's rank-relative stage
    segments for ONE step. Returns::

        {wall_us, crit_rank, crit_stage, crit_frac,
         chain: [{rank, stage, t0_us, t1_us}, ...],   # time order
         stage_us: {stage: chain µs},                 # chain budget
         blocked_us: {rank: total wait µs}}           # per-rank skew

    Walk: start at the wall (the latest rank end; ties → lowest rank)
    and move backward. At each instant the chain takes the current
    rank's latest-starting busy segment; when the current rank is only
    WAITING, the bound is whichever other rank was busy — hand off to
    the candidate whose busy segment ends latest (ties → lowest rank).
    If nobody was busy, the wait itself is the bound (pure skew/model
    error) and joins the chain. A t where NO rank has any segment is a
    profiler gap: jump to the latest segment end below t — the skipped
    span lowers ``crit_frac`` instead of being attributed to anyone.
    """
    ranks = sorted(segs_by_rank)
    ends = {r: max((float(s["t1_us"]) for s in segs_by_rank[r]),
                   default=0.0) for r in ranks}
    wall = max(ends.values(), default=0.0)
    blocked = {r: round(stage_totals(segs_by_rank[r])["wait"], 1)
               for r in ranks}
    out: Dict[str, Any] = {
        "wall_us": round(wall, 1), "crit_rank": None, "crit_stage": None,
        "crit_frac": 0.0, "chain": [], "stage_us": {},
        "blocked_us": blocked,
    }
    if wall <= 0:
        return out
    cur = min(r for r in ranks if ends[r] >= wall - _EPS)
    t = wall
    chain: List[Dict[str, Any]] = []
    while t > _EPS:
        cands = _covering(segs_by_rank[cur], t)
        seg = _pick_busy(cands)
        if seg is None and cands:
            # Current rank is waiting: hand off to a busy rank.
            best = None  # (end, -rank, rank, seg)
            for r in ranks:
                if r == cur:
                    continue
                other = _pick_busy(_covering(segs_by_rank[r], t))
                if other is None:
                    continue
                key = (float(other["t1_us"]), -r)
                if best is None or key > best[0]:
                    best = (key, r, other)
            if best is not None:
                cur, seg = best[1], best[2]
            else:
                # Everyone idle or waiting: the wait IS the bound.
                seg = max(cands,
                          key=lambda s: (float(s["t0_us"]),
                                         -STAGES.index(s["stage"])))
        if seg is None:
            # Gap: no segment on the current rank covers t. Jump to the
            # latest end <= t anywhere; the gap is unexplained time.
            best_end, best_rank = None, None
            for r in ranks:  # ties → lowest rank (sorted + strict >)
                for s in segs_by_rank[r]:
                    e = float(s["t1_us"])
                    if e < t - _EPS and (best_end is None
                                         or e > best_end + _EPS):
                        best_end, best_rank = e, r
            if best_end is None:
                break
            t, cur = best_end, best_rank
            continue
        t0 = float(seg["t0_us"])
        piece_t0 = max(0.0, t0)
        chain.append({"rank": cur, "stage": seg["stage"],
                      "t0_us": round(piece_t0, 1), "t1_us": round(t, 1)})
        t = piece_t0
    chain.reverse()
    # Merge adjacent same-(rank, stage) pieces (a handoff can split one
    # segment when the walk re-enters it).
    merged: List[Dict[str, Any]] = []
    for p in chain:
        if (merged and merged[-1]["rank"] == p["rank"]
                and merged[-1]["stage"] == p["stage"]
                and abs(merged[-1]["t1_us"] - p["t0_us"]) <= 1e-3):
            merged[-1]["t1_us"] = p["t1_us"]
        else:
            merged.append(dict(p))
    chain = merged
    stage_us = {s: 0.0 for s in STAGES}
    rank_us = {r: 0.0 for r in ranks}
    for p in chain:
        length = p["t1_us"] - p["t0_us"]
        stage_us[p["stage"]] += length
        rank_us[p["rank"]] += length
    covered = sum(stage_us.values())
    out["chain"] = chain
    out["stage_us"] = {s: round(us, 1) for s, us in stage_us.items()}
    out["crit_frac"] = round(min(1.0, covered / wall), 6)
    out["crit_stage"] = dominant_stage(stage_us)
    crit_rank, best_us = None, -1.0
    for r in ranks:  # tie → lowest rank (sorted order + strict >)
        if rank_us[r] > best_us + _EPS:
            crit_rank, best_us = r, rank_us[r]
    out["crit_rank"] = crit_rank
    return out


# ------------------------------------------------------------ formatting

def format_critpath(rows: Sequence[Mapping[str, Any]],
                    budgets: Optional[Mapping[int, Mapping[str, float]]]
                    = None) -> str:
    """Render fleet-joined critpath rows: per-step table, per-rank
    stage/wait budget, and the modal-path summary."""
    lines: List[str] = []
    header = ["step", "crit_rank", "crit_stage", "crit_frac", "wall_ms",
              "chain"]
    table = []
    for r in rows:
        chain = " > ".join(
            f"r{p['rank']}:{p['stage']}" for p in r.get("chain", []))
        table.append([str(r.get("step")), f"r{r.get('crit_rank')}",
                      str(r.get("crit_stage")),
                      f"{float(r.get('crit_frac', 0.0)):.4f}",
                      f"{float(r.get('wall_us', 0.0)) / 1e3:.3f}",
                      chain[:72]])
    widths = [max(len(x[i]) for x in [header] + table)
              for i in range(len(header))] if table else []
    if table:
        lines.append("  ".join(c.ljust(w)
                               for c, w in zip(header, widths)))
        lines.append("  ".join("-" * w for w in widths))
        for x in table:
            lines.append("  ".join(c.ljust(w) for c, w in zip(x, widths)))
    else:
        lines.append("(no critpath rows)")
    if budgets:
        lines.append("")
        lines.append("per-rank budget (ms on chain by stage; "
                     "blocked = that rank's total wait):")
        bh = ["rank"] + list(STAGES) + ["blocked"]
        bt = []
        for r in sorted(budgets):
            b = budgets[r]
            bt.append([f"r{r}"]
                      + [f"{float(b.get(s, 0.0)) / 1e3:.3f}"
                         for s in STAGES]
                      + [f"{float(b.get('blocked_us', 0.0)) / 1e3:.3f}"])
        bw = [max(len(x[i]) for x in [bh] + bt) for i in range(len(bh))]
        lines.append("  ".join(c.ljust(w) for c, w in zip(bh, bw)))
        lines.append("  ".join("-" * w for w in bw))
        for x in bt:
            lines.append("  ".join(c.ljust(w) for c, w in zip(x, bw)))
    if rows:
        counts: Dict[str, int] = {}
        for r in rows:
            st = r.get("crit_stage")
            if st:
                counts[st] = counts.get(st, 0) + 1
        modal = dominant_stage({s: float(c) for s, c in counts.items()})
        mean_frac = sum(float(r.get("crit_frac", 0.0))
                        for r in rows) / len(rows)
        lines.append("")
        lines.append(
            f"modal critical stage: {modal}  "
            f"({counts.get(modal, 0)}/{len(rows)} steps)  "
            f"mean crit_frac={mean_frac:.4f}")
    return "\n".join(lines)
