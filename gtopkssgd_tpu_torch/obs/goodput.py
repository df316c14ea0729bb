"""The goodput ledger, the port of ``gtopkssgd_tpu/obs/goodput.py``: one
rank's measured wall-clock split into productive step time (**goodput**)
and a closed **badput** taxonomy.

  category  what it accounts
  --------  ----------------------------------------------------------
  goodput   productive step compute (the compute share of each step)
  select    sparsification overhead: top-k selection + wire codec
  comm      wire time of the sparse exchange (the bytes themselves)
  wait      blocked at collectives for skewed peers + injected slowness
  compile   the one-off work before a step that the JAX package spends
            compiling; in the port: building or loading the CUDA
            kernels (``ops/_build.py``), the first eager step of each new
            batch shape (cuDNN and cuBLAS set-up, lazy module loading)
            and each CUDA-graph capture (``Trainer._capture``)
  ckpt      checkpoint save/restore (incl. emergency preemption saves
            and rollback restores)
  wasted    re-executed work: steps discarded by skip/rollback recovery
  degraded  degraded-mode delta: extra step time while the dense
            fallback replaces the sparse step
  data      input-pipeline stalls (host batch assembly and the copy to
            the device that the step waited on)
  startup   init: trainer construction to the first training step
            (minus any time already attributed, e.g. the kernel build)
  other     the explicit unattributed remainder -- NEVER hidden

Conservation holds by construction: the categories plus ``other`` sum to
the measured wall (``other = wall - sum(categories)``), so nothing is
silently double-counted or dropped; a large ``other_frac`` is a visible
accounting gap. Host-side trace attribution (``trace_attr``) is marked
``None`` and so lands in ``other`` by design.

Two producers, one record shape:

  ``GoodputLedger``  the live accumulator the trainer drives at its sync
      points (``mark``/``step_mark``): each call attributes the wall since
      the previous mark to one category; step time splits into goodput/
      select/comm/wait by the latest critpath stage fractions (all goodput
      without critpath). Every ``interval`` steps it logs one durable
      cumulative ``goodput`` record (fsynced) and feeds ``goodput_frac``
      to the anomaly monitor's ``goodput_collapse`` rule; the trainer logs
      the end-of-run summary (``final=1``) on exit.

  ``fold_shards``  the offline fold: the last cumulative ``goodput``
      record per rank wins; ranks that shipped none get a synthesis from
      the records the run already emits (``synthesize``, tagged
      ``source="folded"``).

``advise`` names the rank whose goodput sits furthest below the fleet
median, the eviction hint; ``format_goodput`` renders the decomposition.
Pure host arithmetic: no torch.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

GOODPUT = "goodput"

# Badput taxonomy, in tie-break order (dominant_badput prefers earlier
# entries on ties — real work overheads before skew before bookkeeping).
BADPUT = ("select", "comm", "wait", "compile", "ckpt", "wasted",
          "degraded", "data", "startup")

# Every accounted category; ``other`` is derived, never accumulated.
CATEGORIES = (GOODPUT,) + BADPUT

_EPS = 1e-9


def _finite(x: Any) -> bool:
    return (isinstance(x, (int, float)) and not isinstance(x, bool)
            and math.isfinite(x))


# --------------------------------------------------------------- records

def decomposition(seconds: Mapping[str, float], wall_s: float,
                  step: Optional[int] = None,
                  n_wasted_steps: int = 0,
                  final: bool = False,
                  source: str = "ledger") -> Dict[str, Any]:
    """The flat cumulative ``goodput`` record (no 'kind' key — callers
    log it as kind="goodput"). Conservation by construction:
    ``other_s = wall_s - sum(categories)`` — a negative ``other_s``
    (only possible via caller double-counting) is surfaced, not
    clamped, so the conservation tests can see it. The fields are rounded
    to the microsecond and ``other_s`` is taken from the rounded ones, so
    the record itself conserves (the JAX record rounds ``other_s`` on its
    own: up to 6 us of slack, over 1e-6 of a few seconds' wall)."""
    wall = float(wall_s)
    rec: Dict[str, Any] = {} if step is None else {"step": int(step)}
    total = 0.0
    shown = 0.0
    for cat in CATEGORIES:
        s = float(seconds.get(cat, 0.0))
        total += s
        rec[f"{cat}_s"] = round(s, 6)
        shown += rec[f"{cat}_s"]
    other = wall - total
    rec["wall_s"] = round(wall, 6)
    rec["other_s"] = round(rec["wall_s"] - shown, 6)
    rec["goodput_frac"] = (round(float(seconds.get(GOODPUT, 0.0)) / wall, 6)
                           if wall > _EPS else 0.0)
    rec["other_frac"] = round(other / wall, 6) if wall > _EPS else 0.0
    rec["n_wasted_steps"] = int(n_wasted_steps)
    rec["final"] = int(bool(final))
    rec["source"] = source
    return rec


def conservation_error(rec: Mapping[str, Any]) -> float:
    """|wall - (categories + other)| / wall — zero (to rounding) for
    any record built by ``decomposition``; the gate smoke pins it."""
    wall = float(rec.get("wall_s", 0.0))
    if wall <= _EPS:
        return 0.0
    total = sum(float(rec.get(f"{c}_s", 0.0)) for c in CATEGORIES)
    total += float(rec.get("other_s", 0.0))
    return abs(wall - total) / wall


def category_fracs(rec: Mapping[str, Any]) -> Dict[str, float]:
    """{category: share of wall}, ``other`` included."""
    wall = float(rec.get("wall_s", 0.0))
    if wall <= _EPS:
        return {c: 0.0 for c in CATEGORIES + ("other",)}
    return {c: float(rec.get(f"{c}_s", 0.0)) / wall
            for c in CATEGORIES + ("other",)}


def dominant_badput(rec: Mapping[str, Any]) -> Optional[str]:
    """Largest badput category by seconds; BADPUT order breaks ties;
    None when no badput was accounted at all (``other`` is an
    accounting gap, not a diagnosis, so it never wins)."""
    best, best_s = None, 0.0
    for cat in BADPUT:
        s = float(rec.get(f"{cat}_s", 0.0))
        if s > best_s + _EPS:
            best, best_s = cat, s
    return best


# ---------------------------------------------------------- live ledger

class GoodputLedger:
    """Cursor-based live accumulator. Every ``mark(category)`` call
    attributes the wall-clock elapsed since the previous mark to one
    category and advances the cursor; ``mark(None)`` advances without
    attributing (the dropped span lands in ``other`` — the honest
    choice for phases the taxonomy genuinely does not cover, e.g.
    host-side trace attribution; eval is productive and accrues to
    goodput). Because each instant is attributed at most once,
    conservation holds by construction.

    ``metrics``/``monitor`` are the trainer's MetricsLogger and
    AnomalyMonitor (either may be None for in-memory use); ``interval``
    is the durable-record cadence in optimizer steps (<= 0 disables
    periodic logging — the end-of-run summary still lands)."""

    def __init__(self, metrics=None, monitor=None, interval: int = 50,
                 clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._cursor = self._t0
        self.metrics = metrics
        self.monitor = monitor
        self.interval = int(interval)
        self.seconds: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self.n_wasted_steps = 0
        self._started = False
        self._fracs: Optional[Dict[str, float]] = None
        # Current-step attribution (so skip/rollback can reclassify the
        # just-executed step as wasted) + the clean-step EWMA the
        # degraded-mode delta is measured against.
        self._cur_step: Dict[str, float] = {}
        self._cur_degraded = False
        self._step_ewma: Optional[float] = None
        self._last_logged: Optional[int] = None

    # ------------------------------------------------------------ cursor
    def mark(self, category: Optional[str]) -> float:
        """Attribute the span since the last mark to ``category`` (one
        of CATEGORIES) and advance the cursor; None drops the span into
        the unattributed remainder. Returns the span in seconds."""
        now = self._clock()
        dt = max(0.0, now - self._cursor)
        self._cursor = now
        if category is not None and dt > 0.0:
            if category not in self.seconds:
                raise ValueError(
                    f"unknown goodput category {category!r} "
                    f"(registered: {CATEGORIES})")
            self.seconds[category] += dt
        return dt

    def train_started(self) -> None:
        """First training step is imminent: everything since
        construction not already attributed (e.g. the kernel build) is
        startup/init. Subsequent calls (fit() re-entering train())
        drop the inter-call span into ``other`` — eval and epoch
        bookkeeping are not startup."""
        if self._started:
            self.mark(None)
            return
        self._started = True
        self.mark("startup")

    def note_stage_fracs(self, critpath_rec: Mapping[str, Any]) -> None:
        """Adopt the latest critpath record's stage shares as the step
        split: compute->goodput, select/comm/wait->their categories.
        Fractions are normalized over the record's own stage totals so
        they always sum to 1 regardless of profiler gaps."""
        tot = {
            GOODPUT: float(critpath_rec.get("t_compute_us", 0.0)),
            "select": float(critpath_rec.get("t_select_us", 0.0)),
            "comm": float(critpath_rec.get("t_comm_wire_us", 0.0)),
            "wait": float(critpath_rec.get("t_wait_us", 0.0)),
        }
        total = sum(tot.values())
        if total <= _EPS:
            return
        self._fracs = {c: v / total for c, v in tot.items()}

    def step_mark(self, begin: bool = False,
                  degraded: bool = False) -> float:
        """Attribute the span since the last mark as step time, split
        by the adopted critpath stage fractions (all goodput when no
        critpath plane is on). ``begin=True`` closes the PREVIOUS
        step's accumulation first (feeding the clean-step EWMA) —
        call it for the dispatch span, then plain ``step_mark()`` for
        the post-step sync reads of the same iteration. While
        ``degraded``, the span's excess over the clean-step EWMA is
        badput (``degraded``), the remainder splits normally."""
        if begin:
            self._close_step()
            self._cur_degraded = False
        dt = self.mark(None)  # cursor advanced; attribute manually below
        if dt <= 0.0:
            return dt
        span = dt
        if degraded:
            self._cur_degraded = True
            if self._step_ewma is not None and span > self._step_ewma:
                extra = span - self._step_ewma
                self.seconds["degraded"] += extra
                self._cur_step["degraded"] = (
                    self._cur_step.get("degraded", 0.0) + extra)
                span = self._step_ewma
        fracs = self._fracs or {GOODPUT: 1.0}
        for cat, f in fracs.items():
            s = span * f
            self.seconds[cat] += s
            self._cur_step[cat] = self._cur_step.get(cat, 0.0) + s
        return dt

    def _close_step(self) -> None:
        if self._cur_step and not self._cur_degraded:
            total = sum(self._cur_step.values())
            a = 0.3
            self._step_ewma = (total if self._step_ewma is None
                               else self._step_ewma
                               + a * (total - self._step_ewma))
        self._cur_step = {}

    def wasted_step(self) -> float:
        """Reclassify the current step's accumulated attribution as
        ``wasted`` — a skip discarded exactly this step's update, a
        rollback discards it and more (the additional rewound progress
        stays where it was honestly spent; only the re-execution to
        come re-earns it). Returns the reclassified seconds."""
        total = 0.0
        for cat, s in self._cur_step.items():
            self.seconds[cat] -= s
            total += s
        if total > 0.0:
            self.seconds["wasted"] += total
        self.n_wasted_steps += 1
        self._cur_step = {}
        return total

    # ----------------------------------------------------------- records
    def wall_s(self) -> float:
        return self._clock() - self._t0

    def snapshot(self, step: int, final: bool = False) -> Dict[str, Any]:
        return decomposition(self.seconds, self.wall_s(), step=step,
                             n_wasted_steps=self.n_wasted_steps,
                             final=final)

    def log_record(self, step: int, final: bool = False) -> Dict[str, Any]:
        """One durable cumulative record (fsync'd — the summary must
        survive a kill one line later) + the monitor feed. AnomalyHalt
        from goodput_collapse propagates AFTER the record is durable,
        like every other monitor halt; the final summary never feeds
        the monitor (the run is already ending)."""
        rec = self.snapshot(step, final=final)
        if self.metrics is not None:
            self.metrics.log("goodput", flush=True, **rec)
        if self.monitor is not None and not final:
            self.monitor.observe_goodput(
                step, goodput_frac=rec["goodput_frac"])
        return rec

    def tick(self, step: int) -> Optional[Dict[str, Any]]:
        """Periodic-record gate for the trainer's sync points: logs one
        cumulative record when ``interval`` steps have passed since the
        last one. The FIRST tick only arms the cadence (short default
        runs stay record-free until the end-of-run summary)."""
        if self.interval <= 0:
            return None
        if self._last_logged is None:
            self._last_logged = int(step)
            return None
        if step - self._last_logged < self.interval:
            return None
        self._last_logged = int(step)
        return self.log_record(step)


# --------------------------------------------------------- offline fold

def _mean_stage_fracs(records: Sequence[Mapping[str, Any]]
                      ) -> Optional[Dict[str, float]]:
    sums = {GOODPUT: 0.0, "select": 0.0, "comm": 0.0, "wait": 0.0}
    n = 0
    for rec in records:
        if rec.get("kind") != "critpath":
            continue
        tot = {
            GOODPUT: float(rec.get("t_compute_us", 0.0)),
            "select": float(rec.get("t_select_us", 0.0)),
            "comm": float(rec.get("t_comm_wire_us", 0.0)),
            "wait": float(rec.get("t_wait_us", 0.0)),
        }
        total = sum(tot.values())
        if total <= _EPS:
            continue
        for c in sums:
            sums[c] += tot[c] / total
        n += 1
    if n == 0:
        return None
    return {c: v / n for c, v in sums.items()}


def synthesize(records: Sequence[Mapping[str, Any]]
               ) -> Optional[Dict[str, Any]]:
    """Best-effort decomposition for a record stream WITHOUT live
    ``goodput`` records, from evidence the run already emits: wall and
    startup from manifest/step-record timing, the step split from mean
    critpath stage fractions (all goodput without critpath), compile
    seconds from ``compile`` records, wasted steps from ``recovery``
    skip/rollback actions priced at the median step duration. An
    estimate — tagged ``source="folded"`` — with everything it could
    not see left in ``other``. None when the stream has no timed step
    records at all."""
    manifest_t: Optional[float] = None
    step_times: Dict[float, float] = {}
    compile_s = 0.0
    wasted_actions = 0
    last_step = 0
    for rec in records:
        kind = rec.get("kind")
        if kind == "manifest" and manifest_t is None:
            if _finite(rec.get("time")):
                manifest_t = float(rec["time"])
        elif kind in ("obs", "train"):
            if _finite(rec.get("step")) and _finite(rec.get("time")):
                s = float(rec["step"])
                step_times[s] = max(step_times.get(s, 0.0),
                                    float(rec["time"]))
                last_step = max(last_step, int(s))
        elif kind == "compile":
            for field in ("lower_s", "compile_s"):
                if _finite(rec.get(field)):
                    compile_s += float(rec[field])
        elif kind == "recovery" and rec.get("action") in ("skip",
                                                          "rollback"):
            wasted_actions += 1
    if not step_times:
        return None
    order = sorted(step_times)
    t_first, t_last = step_times[order[0]], step_times[order[-1]]
    diffs = sorted(b - a for a, b in zip(
        [step_times[s] for s in order],
        [step_times[s] for s in order[1:]]))
    step_dur = diffs[len(diffs) // 2] if diffs else 0.0
    t0 = manifest_t if manifest_t is not None else t_first
    wall = max(0.0, t_last - t0)
    seconds = {c: 0.0 for c in CATEGORIES}
    # Startup: manifest to first step record, minus that first step's
    # own duration (estimated at the median cadence).
    seconds["startup"] = max(0.0, t_first - t0 - step_dur)
    seconds["compile"] = min(compile_s, seconds["startup"])
    seconds["startup"] -= seconds["compile"]
    seconds["wasted"] = wasted_actions * step_dur
    stepped = max(0.0, wall - seconds["startup"] - seconds["compile"]
                  - seconds["wasted"])
    fracs = _mean_stage_fracs(records) or {GOODPUT: 1.0}
    for cat, f in fracs.items():
        seconds[cat] += stepped * f
    return decomposition(seconds, wall, step=last_step,
                         n_wasted_steps=wasted_actions, final=True,
                         source="folded")


def fold(records: Sequence[Mapping[str, Any]]
         ) -> Optional[Dict[str, Any]]:
    """One rank's decomposition: the LAST cumulative ``goodput`` record
    wins (the ledger's records are cumulative, so the last one IS the
    run's accounting); streams without any fall back to
    ``synthesize``."""
    last = None
    for rec in records:
        if rec.get("kind") == "goodput":
            last = rec
    if last is not None:
        out = {k: v for k, v in last.items()
               if k not in ("kind", "time", "rank")}
        out.setdefault("source", "ledger")
        return out
    return synthesize(records)


def fold_shards(records_by_rank: Mapping[int, Sequence[Mapping[str, Any]]]
                ) -> Dict[int, Dict[str, Any]]:
    """{rank: decomposition} over fleet shards; ranks whose streams
    yield nothing (no goodput records AND nothing to synthesize from)
    are absent, never invented."""
    out: Dict[int, Dict[str, Any]] = {}
    for rank in sorted(records_by_rank):
        d = fold(records_by_rank[rank])
        if d is not None:
            out[rank] = d
    return out


def fleet_decomposition(decomp_by_rank: Mapping[int, Mapping[str, Any]]
                        ) -> Optional[Dict[str, Any]]:
    """Whole-fleet decomposition: wall-weighted sum of the per-rank
    category seconds (a rank-second is a rank-second — the fleet's
    goodput_frac is total productive rank-time over total rank-time)."""
    if not decomp_by_rank:
        return None
    seconds = {c: 0.0 for c in CATEGORIES}
    wall = 0.0
    wasted = 0
    for d in decomp_by_rank.values():
        wall += float(d.get("wall_s", 0.0))
        wasted += int(d.get("n_wasted_steps", 0) or 0)
        for c in CATEGORIES:
            seconds[c] += float(d.get(f"{c}_s", 0.0))
    rec = decomposition(seconds, wall, n_wasted_steps=wasted, final=True,
                        source="fleet")
    rec["n_ranks"] = len(decomp_by_rank)
    return rec


# ------------------------------------------------------- advise / render

def advise(decomp_by_rank: Mapping[int, Mapping[str, Any]],
           margin: float = 0.1) -> Optional[Dict[str, Any]]:
    """The eviction hint: the rank whose goodput_frac
    sits furthest below the fleet median by more than ``margin``
    (absolute), with its dominant badput category — the difference
    between "evict rank 2" and "rank 2 spends 48% of its wall blocked
    at collectives; evicting or replacing it recovers ~X s of fleet
    time". None when no rank stands out (a healthy fleet gets no
    advice) or the fleet has < 2 ranks (nothing to evict INTO)."""
    if len(decomp_by_rank) < 2:
        return None
    fracs = {r: float(d.get("goodput_frac", 0.0))
             for r, d in decomp_by_rank.items()}
    med = sorted(fracs.values())[len(fracs) // 2] if len(fracs) % 2 else \
        0.5 * sum(sorted(fracs.values())[len(fracs) // 2 - 1:
                                         len(fracs) // 2 + 1])
    worst = min(sorted(fracs), key=lambda r: fracs[r])
    if med - fracs[worst] <= margin:
        return None
    d = decomp_by_rank[worst]
    cat = dominant_badput(d)
    lost = (med - fracs[worst]) * float(d.get("wall_s", 0.0))
    return {
        "rank": worst,
        "goodput_frac": round(fracs[worst], 6),
        "fleet_median_frac": round(med, 6),
        "dominant_badput": cat,
        "recoverable_s": round(lost, 6),
    }


def _bar(frac: float, width: int = 20) -> str:
    n = int(round(max(0.0, min(1.0, frac)) * width))
    return "#" * n + "." * (width - n)


def format_goodput(decomp_by_rank: Mapping[int, Mapping[str, Any]],
                   fleet: Optional[Mapping[str, Any]] = None,
                   compare: Optional[Mapping[int, Mapping[str, Any]]]
                   = None,
                   hint: Optional[Mapping[str, Any]] = None) -> str:
    """Render the decomposition as a text report:
    per-rank category table + goodput bars, the whole-fleet line, an
    optional clean-vs-chaos compare (per-category frac deltas against a
    second run's fleet decomposition) and the ``--advise`` hint."""
    cols = ["rank", "wall_s", GOODPUT] + list(BADPUT) + ["other", "src"]
    lines: List[str] = []
    table: List[List[str]] = []
    for rank in sorted(decomp_by_rank):
        d = decomp_by_rank[rank]
        fr = category_fracs(d)
        table.append(
            [f"r{rank}", f"{float(d.get('wall_s', 0.0)):.3f}"]
            + [f"{fr[c]:.4f}" for c in (GOODPUT,) + BADPUT + ("other",)]
            + [str(d.get("source", "?"))])
    if table:
        widths = [max(len(x[i]) for x in [cols] + table)
                  for i in range(len(cols))]
        lines.append("  ".join(c.ljust(w) for c, w in zip(cols, widths)))
        lines.append("  ".join("-" * w for w in widths))
        for x in table:
            lines.append("  ".join(c.ljust(w) for c, w in zip(x, widths)))
        lines.append("")
        for rank in sorted(decomp_by_rank):
            d = decomp_by_rank[rank]
            gf = float(d.get("goodput_frac", 0.0))
            bad = dominant_badput(d)
            lines.append(f"r{rank} goodput [{_bar(gf)}] {gf:.1%}"
                         + (f"  worst badput: {bad}" if bad else ""))
    else:
        lines.append("(no goodput decomposition — no goodput records "
                     "and nothing to synthesize from)")
    if fleet is not None:
        lines.append("")
        lines.append(
            f"fleet ({fleet.get('n_ranks', '?')} ranks): goodput "
            f"{float(fleet.get('goodput_frac', 0.0)):.1%} of "
            f"{float(fleet.get('wall_s', 0.0)):.3f} rank-seconds, "
            f"other {float(fleet.get('other_frac', 0.0)):.1%}, "
            f"{int(fleet.get('n_wasted_steps', 0) or 0)} wasted steps")
    if compare is not None:
        ours = fleet or fleet_decomposition(decomp_by_rank)
        theirs = fleet_decomposition(compare)
        if ours is not None and theirs is not None:
            lines.append("")
            lines.append("vs compare run (this - other, share of wall):")
            fa, fb = category_fracs(ours), category_fracs(theirs)
            for c in (GOODPUT,) + BADPUT + ("other",):
                d = fa[c] - fb[c]
                if abs(d) >= 0.0005:
                    lines.append(f"  {c:<9} {fa[c]:>7.4f} vs {fb[c]:>7.4f}"
                                 f"  ({d:+.4f})")
    if hint is not None:
        lines.append("")
        lines.append(
            f"advise: evict/replace rank {hint['rank']} — goodput "
            f"{float(hint['goodput_frac']):.1%} vs fleet median "
            f"{float(hint['fleet_median_frac']):.1%}, dominant badput "
            f"{hint['dominant_badput']}; recovers "
            f"~{float(hint['recoverable_s']):.1f} rank-seconds")
    elif hint is None and compare is None and len(decomp_by_rank) >= 2:
        pass
    return "\n".join(lines)
