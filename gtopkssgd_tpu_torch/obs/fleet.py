"""The fleet merge, the port of ``gtopkssgd_tpu/obs/fleet.py``: the ranks'
metric shards joined, and the slow rank named.

A synchronous step lasts as long as its slowest rank, and at P > 1 every
rank writes its own shard (``metrics.rank{r}.jsonl``); this module reads
them side by side. All host-side, standard library only:

  find_shards / load_shards  the shards of a run dir (``metrics.jsonl``
      reads as rank 0) and their records.
  validate_shards            a merge is refused when the manifests'
      ``config_hash`` (``utils.manifest.config_hash``) differs: two runs
      in one dir are not a fleet.
  fleet_rows                 one row per (kind, step, field): min, median,
      max, mean, std across the ranks, each rank's skew from the median;
      and a ``lag_s`` row per (kind, step) from the records' wall-clock
      times: how far behind the first rank each one logged.
  straggler_rows             the slowest rank at each step, its lag behind
      the median, and whether it is persistent: a per-rank EWMA of the lag
      fed through ``AnomalyMonitor.observe_ranks``, whose
      ``straggler_persistent`` rule writes an ordinary "event" record
      (``--obs-halt-on`` halts on it). A row carries the slow rank's own
      critical stage, dominant badput and slowest link where that rank
      logged "critpath", "goodput" or "linkmap" records.
  goodput_rows               each rank's goodput decomposition
      (``obs.goodput.fold``) and the fleet's, the input of
      ``goodput.advise`` and of ``resilience.elastic.eviction_decision``.
  critpath_rows              the ranks' "critpath" records joined by step
      into the global critical path (``obs.critpath.critical_path``),
      fed through ``observe_critpath`` (``critpath_shift``).
  merge                      all of the above in one call: the ``report
      fleet`` subcommand and the trainer's eviction self-check.

Ragged shards are normal: a rank missing a step (killed, behind, logging
less often) drops out of that step's statistics (``n_ranks`` says how
many ranks a row holds); it never stops the merge.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from gtopkssgd_tpu_torch.obs import critpath as _critpath
from gtopkssgd_tpu_torch.obs import goodput as _goodput
from gtopkssgd_tpu_torch.obs.events import AnomalyMonitor
from gtopkssgd_tpu_torch.obs.report import extract_manifest, load_records
from gtopkssgd_tpu_torch.utils.metrics import shard_filename, shard_rank

# Record kinds that carry a per-step stream worth merging across ranks.
# "layers" is excluded by default (per-layer x per-rank explodes row
# count); pass kinds=("layers",) explicitly to get it.
DEFAULT_KINDS = ("obs", "train", "spans")

# Fields that are bookkeeping, not per-rank measurements.
_SKIP_FIELDS = {"kind", "time", "rank", "step"}


def find_shards(target: str) -> Dict[int, str]:
    """{rank: path} for one target.

    A directory yields its ``metrics.rank{r}.jsonl`` shards, falling back
    to ``metrics.jsonl`` as rank 0 (single-process runs merge as a
    1-rank fleet — skew 0 by construction). A file path yields the rank
    encoded in its name, or rank 0 for non-shard names.
    """
    if os.path.isdir(target):
        shards = {}
        for name in sorted(os.listdir(target)):
            r = shard_rank(name)
            if r is not None:
                shards[r] = os.path.join(target, name)
        if not shards:
            single = os.path.join(target, "metrics.jsonl")
            if os.path.exists(single):
                shards[0] = single
        if not shards:
            raise FileNotFoundError(
                f"{target}: no metrics.rank*.jsonl shards and no "
                "metrics.jsonl")
        return shards
    r = shard_rank(target)
    return {r if r is not None else 0: target}


def resolve_targets(targets: Sequence[str]) -> Dict[int, str]:
    """Union of find_shards over many targets (dirs and/or files). Two
    targets claiming the same rank is a usage error — the caller is about
    to merge two different runs' shards under one join key."""
    shards: Dict[int, str] = {}
    for t in targets:
        for r, path in find_shards(t).items():
            if r in shards and os.path.abspath(shards[r]) != \
                    os.path.abspath(path):
                raise ValueError(
                    f"rank {r} appears twice ({shards[r]} and {path}); "
                    "merge one run's shards at a time")
            shards[r] = path
    return shards


def load_shards(shards: Mapping[int, str]
                ) -> Tuple[Dict[int, List[dict]], int]:
    """{rank: records} plus the total malformed-line count (torn final
    lines in killed runs are expected, never fatal)."""
    out, bad = {}, 0
    for r in sorted(shards):
        records, b = load_records(shards[r])
        out[r] = records
        bad += b
    return out, bad


def validate_shards(records_by_rank: Mapping[int, List[dict]],
                    allow_mismatch: bool = False) -> Optional[dict]:
    """Check every shard's manifest header agrees on ``config_hash`` (the
    full-config join key) and return the reference manifest. Shards
    without a manifest are tolerated (pre-manifest runs, hand-built
    fixtures); a HASH MISMATCH is refused — those shards are provably
    from different runs and any per-step comparison would be noise."""
    manifests = {r: extract_manifest(recs)
                 for r, recs in records_by_rank.items()}
    hashes = {r: m.get("config_hash") for r, m in manifests.items()
              if m is not None and m.get("config_hash")}
    if len(set(hashes.values())) > 1 and not allow_mismatch:
        detail = ", ".join(f"rank {r}: {h}" for r, h in sorted(hashes.items()))
        raise ValueError(
            f"config_hash mismatch across shards ({detail}); these are "
            "different runs — re-merge with matching shards (or "
            "allow_mismatch=True to force)")
    for m in manifests.values():
        if m is not None:
            return m
    return None


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _std(vals: Sequence[float], mean: float) -> float:
    if len(vals) < 2:
        return 0.0
    return math.sqrt(sum((v - mean) ** 2 for v in vals) / len(vals))


def _stats_row(src: str, step: float, field: str,
               per_rank: Dict[int, float], center: str = "median") -> dict:
    vals = list(per_rank.values())
    mean = sum(vals) / len(vals)
    med = _median(vals)
    ref = med if center == "median" else min(vals)
    skew = {f"r{r}": per_rank[r] - ref for r in sorted(per_rank)}
    return {
        "src": src, "step": step, "field": field,
        "n_ranks": len(per_rank),
        "min": min(vals), "median": med, "max": max(vals),
        "mean": mean, "std": _std(vals, mean),
        "skew": skew,
        "skew_max": max(abs(d) for d in skew.values()),
    }


def _index_by_step(records_by_rank: Mapping[int, List[dict]],
                   kinds: Sequence[str]
                   ) -> Dict[Tuple[str, float], Dict[int, dict]]:
    """{(kind, step): {rank: record}} — last record wins when a rank
    logged the same (kind, step) twice (restarted window)."""
    idx: Dict[Tuple[str, float], Dict[int, dict]] = {}
    for rank, records in records_by_rank.items():
        for rec in records:
            kind = rec.get("kind")
            step = rec.get("step")
            if kind not in kinds or not isinstance(step, (int, float)) \
                    or isinstance(step, bool):
                continue
            idx.setdefault((str(kind), float(step)), {})[rank] = rec
    return idx


def fleet_rows(records_by_rank: Mapping[int, List[dict]],
               kinds: Sequence[str] = DEFAULT_KINDS) -> List[dict]:
    """The merged view: one row per (src kind, step, field) with cross-
    rank min/median/max/mean/std and the per-rank skew vector, plus a
    ``lag_s`` row per (src kind, step) from record arrival times (value
    per rank = seconds behind the FIRST rank to log that step — the
    direct fingerprint of the host everyone else waited for)."""
    rows: List[dict] = []
    for (kind, step), per_rank in sorted(_index_by_step(
            records_by_rank, kinds).items()):
        fields = sorted({
            key for rec in per_rank.values() for key, val in rec.items()
            if key not in _SKIP_FIELDS and not isinstance(val, bool)
            and isinstance(val, (int, float))
        })
        for field in fields:
            vals = {r: float(rec[field]) for r, rec in per_rank.items()
                    if isinstance(rec.get(field), (int, float))
                    and not isinstance(rec.get(field), bool)}
            if vals:
                rows.append(_stats_row(kind, step, field, vals))
        times = {r: float(rec["time"]) for r, rec in per_rank.items()
                 if isinstance(rec.get("time"), (int, float))}
        if times:
            t0 = min(times.values())
            lags = {r: t - t0 for r, t in times.items()}
            rows.append(_stats_row(kind, step, "lag_s", lags, center="min"))
    return rows


def _arrival_times(records_by_rank: Mapping[int, List[dict]],
                   kind: str) -> Dict[float, Dict[int, float]]:
    out: Dict[float, Dict[int, float]] = {}
    for (k, step), per_rank in _index_by_step(
            records_by_rank, (kind,)).items():
        times = {r: float(rec["time"]) for r, rec in per_rank.items()
                 if isinstance(rec.get("time"), (int, float))}
        if times:
            out[step] = times
    return out


def pick_straggler_kind(records_by_rank: Mapping[int, List[dict]],
                        preferred: Sequence[str] = ("obs", "train")
                        ) -> Optional[str]:
    """The densest per-step stream present on >= 2 ranks wins — obs
    records usually fire more often than train records."""
    for kind in preferred:
        times = _arrival_times(records_by_rank, kind)
        if times and max(len(t) for t in times.values()) >= 2:
            return kind
    for kind in preferred:  # 1-rank fleet: still produce (empty-lag) rows
        if _arrival_times(records_by_rank, kind):
            return kind
    return None


def _goodput_by_rank(records_by_rank: Mapping[int, List[dict]]
                     ) -> Dict[int, List[dict]]:
    """{rank: [goodput records sorted by step]} — the cumulative ledger
    stream each rank shipped (possibly empty)."""
    out: Dict[int, List[dict]] = {}
    for rank, records in records_by_rank.items():
        recs = [r for r in records if r.get("kind") == "goodput"
                and isinstance(r.get("step"), (int, float))
                and not isinstance(r.get("step"), bool)]
        if recs:
            recs.sort(key=lambda r: float(r["step"]))
            out[rank] = recs
    return out


def _badput_at(gp_recs: Optional[List[dict]], step: float
               ) -> Tuple[Optional[str], Optional[float]]:
    """(dominant badput category, its wall fraction) from the latest
    cumulative goodput record at or before ``step`` (falling back to the
    rank's first record when the straggler row predates the first ledger
    log). (None, None) when the rank shipped no goodput records."""
    if not gp_recs:
        return None, None
    rec = gp_recs[0]
    for cand in gp_recs:
        if float(cand["step"]) <= step:
            rec = cand
        else:
            break
    cat = _goodput.dominant_badput(rec)
    if cat is None:
        return None, None
    return cat, _goodput.category_fracs(rec).get(cat)


def goodput_rows(records_by_rank: Mapping[int, List[dict]]
                 ) -> Tuple[List[dict], Dict[int, dict], Optional[dict]]:
    """Per-rank goodput/badput decomposition + the fleet roll-up.

    Returns (rows, decomp_by_rank, fleet). One row per rank: the folded
    end-of-run decomposition (obs/goodput.py ``fold`` — last cumulative
    ledger record, or a synthesis from critpath/compile/recovery
    evidence when the rank shipped none) plus its dominant badput
    category. ``fleet`` is the wall-weighted whole-fleet decomposition
    (None for an empty fleet) — the single number ("this fleet's
    rank-seconds were X% productive") and the input to ``advise``."""
    decomp_by_rank = _goodput.fold_shards(records_by_rank)
    rows: List[dict] = []
    for rank in sorted(decomp_by_rank):
        d = decomp_by_rank[rank]
        row = {"src": "goodput", "field": "goodput", "rank": rank,
               "badput": _goodput.dominant_badput(d)}
        row.update({k: v for k, v in d.items() if k not in row})
        rows.append(row)
    fleet = (_goodput.fleet_decomposition(decomp_by_rank)
             if decomp_by_rank else None)
    return rows, decomp_by_rank, fleet


def _linkmap_by_rank(records_by_rank: Mapping[int, List[dict]]
                     ) -> Dict[int, List[dict]]:
    """{rank: [linkmap records sorted by step]} — each rank's weather-
    map snapshots (possibly empty)."""
    out: Dict[int, List[dict]] = {}
    for rank, records in records_by_rank.items():
        recs = [r for r in records if r.get("kind") == "linkmap"
                and isinstance(r.get("step"), (int, float))
                and not isinstance(r.get("step"), bool)]
        if recs:
            recs.sort(key=lambda r: float(r["step"]))
            out[rank] = recs
    return out


def _slow_link_at(lm_recs: Optional[List[dict]], step: float
                  ) -> Tuple[Optional[str], Optional[float]]:
    """(worst link key, its EWMA-over-fleet-median factor) from the
    straggling rank's latest weather-map record at or before ``step``
    (falling back to its first record when the straggler row predates
    the first capture). (None, None) when the rank shipped no linkmap
    records — pre-linkmap shards merge unchanged."""
    if not lm_recs:
        return None, None
    rec = lm_recs[0]
    for cand in lm_recs:
        if float(cand["step"]) <= step:
            rec = cand
        else:
            break
    link = rec.get("worst_link")
    if not isinstance(link, str) or not link:
        return None, None
    x = rec.get("worst_over_median_x")
    return link, (float(x) if isinstance(x, (int, float))
                  and not isinstance(x, bool) else None)


def straggler_rows(records_by_rank: Mapping[int, List[dict]],
                   kind: Optional[str] = None,
                   monitor: Optional[AnomalyMonitor] = None
                   ) -> Tuple[List[dict], List[dict]]:
    """Per-step slowest-rank attribution + persistence classification.

    Returns (rows, events). Each row: which rank arrived last at that
    step's record, its lag behind the median arrival, and whether its
    EWMA lag marks it persistent (the same host every step) or transient
    (GC pause, one slow input batch). ``monitor`` carries the EWMA state
    and the ``straggler_persistent`` rule — pass the trainer's monitor
    (halt_on set) to make a persistent straggler fail fast; the default
    records only. When the slowest rank shipped ``linkmap`` records,
    the row also carries its dominant slow link (``slow_link`` /
    ``slow_link_x``) — the difference between "rank 2 is late" and
    "rank 2 is late and its dcn hop to rank 5 is 4x the fleet median".
    """
    kind = kind or pick_straggler_kind(records_by_rank)
    if kind is None:
        return [], []
    # The slowest rank's LOCAL critical stage (from its critpath record
    # at that step, when it shipped one): why that host was late, not
    # just that it was.
    crit_idx = _index_by_step(records_by_rank, ("critpath",))
    # And its dominant badput category (from its cumulative ``goodput``
    # records, when it shipped any): the decomposition's verdict on
    # WHERE that host's lost time goes — wait vs wasted vs ckpt — which
    # is the column ``report goodput --advise`` reasons from.
    gp_idx = _goodput_by_rank(records_by_rank)
    # And its dominant slow link (from its ``linkmap`` weather-map
    # records, when it shipped any): WHICH hop is dragging that host.
    lm_idx = _linkmap_by_rank(records_by_rank)
    by_step = _arrival_times(records_by_rank, kind)
    steps = sorted(by_step)
    med_arrivals = [_median(list(by_step[s].values())) for s in steps]
    diffs = sorted(b - a for a, b in zip(med_arrivals, med_arrivals[1:]))
    step_dur = diffs[len(diffs) // 2] if diffs else None

    monitor = monitor or AnomalyMonitor()
    rows: List[dict] = []
    for step in steps:
        times = by_step[step]
        if len(times) < 2:
            continue
        med = _median(list(times.values()))
        lags = {r: t - min(times.values()) for r, t in times.items()}
        slowest = max(times, key=times.get)
        events_before = len(monitor.events)
        monitor.observe_ranks(step, lags, step_dur=step_dur)
        fired = monitor.events[events_before:]
        crec = crit_idx.get(("critpath", step), {}).get(slowest) or {}
        badput, badput_frac = _badput_at(gp_idx.get(slowest), step)
        slow_link, slow_link_x = _slow_link_at(lm_idx.get(slowest), step)
        rows.append({
            "src": kind, "step": step, "field": "straggler",
            "n_ranks": len(times),
            "slowest_rank": slowest,
            "behind_median_s": times[slowest] - med,
            "lag_s": lags[slowest],
            "ewma_lag_s": monitor.rank_lag_ewma.get(slowest, 0.0),
            "persistent": any(ev["rule"] == "straggler_persistent"
                              for ev in fired),
            "stage": crec.get("crit_stage"),
            "badput": badput,
            "badput_frac": badput_frac,
            "slow_link": slow_link,
            "slow_link_x": slow_link_x,
        })
    return rows, list(monitor.events)


def critpath_rows(records_by_rank: Mapping[int, List[dict]],
                  monitor: Optional[AnomalyMonitor] = None
                  ) -> Tuple[List[dict], Dict[int, Dict[str, float]]]:
    """The global critical path: join per-rank ``critpath`` stage-
    interval records by step and run obs/critpath.py's deterministic
    chain walk over each step's segment sets.

    Returns (rows, budgets). Each row: the step's crit_rank/crit_stage,
    ``crit_frac`` (how much of the step wall the chain explains), the
    (rank, stage) chain itself, and per-rank blocked (wait) time.
    ``budgets`` accumulates across steps: per rank, µs ON the chain by
    stage plus total ``blocked_us`` — the eviction-decision view (which
    host binds the fleet, and with which stage). ``monitor`` carries the
    ``critpath_shift`` modal-stage state; pass the trainer's monitor
    (halt_on set) to make a moved bottleneck fail fast."""
    idx = _index_by_step(records_by_rank, ("critpath",))
    monitor = monitor or AnomalyMonitor()
    rows: List[dict] = []
    budgets: Dict[int, Dict[str, float]] = {}
    for (_, step), per_rank in sorted(idx.items()):
        segs_by_rank = {
            r: rec.get("segments") or [] for r, rec in per_rank.items()}
        res = _critpath.critical_path(segs_by_rank)
        events_before = len(monitor.events)
        monitor.observe_critpath(step, crit_stage=res["crit_stage"])
        fired = monitor.events[events_before:]
        rows.append({
            "src": "critpath", "step": step, "field": "critpath",
            "n_ranks": len(per_rank),
            "crit_rank": res["crit_rank"],
            "crit_stage": res["crit_stage"],
            "crit_frac": res["crit_frac"],
            "wall_us": res["wall_us"],
            "chain": res["chain"],
            "stage_us": res["stage_us"],
            "blocked_us": {f"r{r}": us
                           for r, us in res["blocked_us"].items()},
            "shift": any(ev["rule"] == "critpath_shift" for ev in fired),
        })
        for p in res["chain"]:
            b = budgets.setdefault(
                p["rank"], {s: 0.0 for s in _critpath.STAGES})
            b[p["stage"]] += p["t1_us"] - p["t0_us"]
        for r, us in res["blocked_us"].items():
            b = budgets.setdefault(r, {s: 0.0 for s in _critpath.STAGES})
            b["blocked_us"] = b.get("blocked_us", 0.0) + us
    for b in budgets.values():
        for key in list(b):
            b[key] = round(b[key], 1)
    return rows, budgets


def through(records_by_rank: Mapping[int, List[dict]], step: float
            ) -> Dict[int, List[dict]]:
    """The records of steps up to `step` (records without a step, the
    manifest, stay): the view every rank had written by a given
    boundary."""
    def keep(rec: dict) -> bool:
        s = rec.get("step")
        return (not isinstance(s, (int, float)) or isinstance(s, bool)
                or s <= step)
    return {r: [rec for rec in recs if keep(rec)]
            for r, recs in records_by_rank.items()}


def merge(targets: Sequence[str],
          kinds: Sequence[str] = DEFAULT_KINDS,
          straggler_kind: Optional[str] = None,
          monitor: Optional[AnomalyMonitor] = None,
          allow_mismatch: bool = False,
          through_step: Optional[float] = None) -> Dict[str, Any]:
    """One-call fleet merge: resolve + load + validate shards, build the
    merged stat rows, the straggler attribution and the critical-path
    join; with `through_step`, over the records of steps up to it only
    (``through``: the trainer's eviction check). Raises on unreadable
    targets, duplicate ranks, and config_hash mismatch (see
    validate_shards); AnomalyHalt propagates when ``monitor`` has
    ``halt_on`` set and a persistent straggler (or a critical-stage
    shift) fires."""
    shards = resolve_targets(targets)
    records_by_rank, bad = load_shards(shards)
    if through_step is not None:
        records_by_rank = through(records_by_rank, through_step)
    manifest = validate_shards(records_by_rank,
                               allow_mismatch=allow_mismatch)
    rows = fleet_rows(records_by_rank, kinds=kinds)
    # One monitor carries both rules' state so merge()'s events list is
    # the single ordered stream --obs-halt-on acts on.
    monitor = monitor or AnomalyMonitor()
    stragglers, _ = straggler_rows(
        records_by_rank, kind=straggler_kind, monitor=monitor)
    crit_rows, crit_budget = critpath_rows(records_by_rank,
                                           monitor=monitor)
    gp_rows, gp_by_rank, gp_fleet = goodput_rows(records_by_rank)
    # Forecast plane: the last forecast record any rank shipped (rank 0
    # in practice — the StepForecaster is fed from each rank's own
    # budgets, and the per-P grid is rank-agnostic). None pre-forecast.
    forecast = None
    for rank in sorted(records_by_rank):
        for rec in records_by_rank[rank]:
            if rec.get("kind") == "forecast":
                forecast = rec
    return {
        "shards": {r: shards[r] for r in sorted(shards)},
        "ranks": sorted(shards),
        "n_malformed": bad,
        "manifest": manifest,
        "rows": rows,
        "stragglers": stragglers,
        "critpath": crit_rows,
        "critpath_budget": crit_budget,
        "goodput": gp_rows,
        "goodput_by_rank": gp_by_rank,
        "goodput_fleet": gp_fleet,
        "forecast": forecast,
        "events": list(monitor.events),
    }


def row_record(row: dict) -> dict:
    """A merged row as MetricsLogger-loggable fields (kind="fleet"):
    drops nothing — the skew dict is JSON-native — but guards against
    key collisions with the logger's own meta fields."""
    return {k: v for k, v in row.items() if k not in ("kind", "time",
                                                      "rank")}


def fleet_shard_name(rank: int) -> str:
    """Re-export so callers needing the naming contract import one
    module (the merger) rather than reaching into utils."""
    return shard_filename(rank)
