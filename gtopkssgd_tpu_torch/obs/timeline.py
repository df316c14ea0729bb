"""Host-side timeline export, the port of ``gtopkssgd_tpu/obs/timeline.py``:
one Chrome-trace/Perfetto JSON a run.

A ``TimelineRecorder`` collects

  * every closed ``Tracer`` span (data / dispatch / forward_backward /
    optimizer / obs_read, nested paths intact) as a duration event on the
    emitting thread's lane,
  * per-step telemetry as counter tracks (loss, achieved density,
    residual norm), and
  * anomaly events and watchdog stalls as instant markers,

then writes a standard ``traceEvents`` JSON (``--obs-timeline PATH``) that
chrome://tracing or Perfetto opens. It records host spans only; a
``torch.profiler`` trace of the same steps carries the same range names
(the Tracer opens both).

``timeline_from_records`` rebuilds a coarser timeline from a run's metrics
records (markers and counters at their recorded wall-clock times);
``validate_timeline`` is the schema check. With the trace planes the
rebuilt timeline also carries a stage lane a rank from the "critpath"
records (the cross-rank critical path's segments flagged), a lane a link
from the "linkmap" records' carved rounds, and the goodput and badput
counter tracks.

Timestamps are wall-clock microseconds (the chrome-trace convention); a
span's start is mapped from the Tracer's perf_counter clock through a base
pair sampled at construction, so spans and markers share one axis.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_META = ("process_name", "thread_name", "process_sort_index")


class TimelineRecorder:
    """Thread-safe accumulator for one run's host timeline."""

    def __init__(self, rank: int = 0, label: str = "trainer"):
        self.rank = rank
        self.label = label
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._base_wall = time.time()
        self._base_perf = time.perf_counter()
        self._tids: Dict[int, int] = {}

    # ------------------------------------------------------------- clocks
    def _now_us(self) -> float:
        return time.time() * 1e6

    def _perf_to_us(self, t_perf: float) -> float:
        return (self._base_wall + (t_perf - self._base_perf)) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
                self._events.append({
                    "ph": "M", "name": "thread_name", "pid": self.rank,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                })
            return tid

    # ------------------------------------------------------------ emitters
    def span_sink(self, path: str, t0_perf: float, dur_s: float) -> None:
        """Tracer sink: one duration event per closed span. Signature is
        the Tracer's ``sink`` contract (path, perf_counter start,
        seconds)."""
        tid = self._tid()
        with self._lock:
            self._events.append({
                "ph": "X", "name": path, "cat": "host_span",
                "ts": self._perf_to_us(t0_perf), "dur": dur_s * 1e6,
                "pid": self.rank, "tid": tid,
            })

    def instant(self, name: str, args: Optional[Dict[str, Any]] = None,
                ts_us: Optional[float] = None) -> None:
        """Moment marker (anomaly event, watchdog stall)."""
        tid = self._tid()
        with self._lock:
            self._events.append({
                "ph": "i", "s": "p", "name": name, "cat": "marker",
                "ts": self._now_us() if ts_us is None else ts_us,
                "pid": self.rank, "tid": tid,
                **({"args": args} if args else {}),
            })

    def counter(self, name: str, values: Dict[str, float],
                ts_us: Optional[float] = None) -> None:
        """Counter track sample — Perfetto renders a line graph per key."""
        vals = {k: float(v) for k, v in values.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
                and float(v) == float(v)}  # NaN samples break the track
        if not vals:
            return
        with self._lock:
            self._events.append({
                "ph": "C", "name": name,
                "ts": self._now_us() if ts_us is None else ts_us,
                "pid": self.rank, "tid": 0, "args": vals,
            })

    # -------------------------------------------------------------- output
    def to_doc(self) -> dict:
        with self._lock:
            events = list(self._events)
        meta = [{"ph": "M", "name": "process_name", "pid": self.rank,
                 "args": {"name": f"host {self.label} rank {self.rank}"}}]
        meta += [e for e in events if e.get("ph") == "M"]
        body = sorted((e for e in events if e.get("ph") != "M"),
                      key=lambda e: e.get("ts", 0.0))
        return {"traceEvents": meta + body, "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        """Write the timeline JSON; a directory path gets timeline.json
        appended. Returns the file written."""
        if os.path.isdir(path) or path.endswith(os.sep):
            path = os.path.join(path, "timeline.json")
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_doc(), fh)
            fh.write("\n")
        return path


# ----------------------------------------------------- offline + validate

# Metrics record kinds rendered as counter tracks offline, and the fields
# each contributes (a missing field is just skipped).
_COUNTER_KINDS = {
    "train": ("loss", "throughput"),
    "obs": ("achieved_density", "residual_norm", "grad_norm_post", "tau"),
    "goodput": ("goodput_frac", "other_frac"),
}
_MARKER_KINDS = ("event", "stall")


def timeline_from_records(records: List[dict],
                          label: str = "run") -> dict:
    """Rebuild a coarse timeline from metrics records: counter samples for
    the train/obs numbers and the goodput shares (with a stacked badput
    track), and instant markers for event/stall records, at their recorded
    wall-clock times. Span durations are not rebuilt (the records carry
    window means, not start times): ``--obs-timeline`` keeps the live span
    view.

    ``critpath`` records (obs/critpath.py) additionally get per-rank
    STAGE LANES: one duration event per stage segment on a dedicated
    lane per rank, anchored so each rank's step window ends at its
    record's wall-clock time, with ``args.critical`` marking the
    segments the step's global (cross-rank) critical path runs
    through — the Perfetto view of "which rank, which stage"."""
    events: List[dict] = [{
        "ph": "M", "name": "process_name", "pid": 0,
        "args": {"name": f"host {label} (from metrics.jsonl)"},
    }, {
        "ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
        "args": {"name": "records"},
    }]
    body: List[dict] = []
    # ---- critpath stage lanes: group records by step across ranks so
    # the global chain can flag the critical segments.
    crit_by_step: Dict[float, Dict[int, dict]] = {}
    for rec in records:
        if (rec.get("kind") == "critpath"
                and isinstance(rec.get("step"), (int, float))
                and isinstance(rec.get("time"), (int, float))
                and isinstance(rec.get("segments"), list)):
            crit_by_step.setdefault(
                float(rec["step"]), {})[int(rec.get("rank", 0))] = rec
    if crit_by_step:
        # Lazy import: keeps the module's offline path stdlib-only for
        # runs without a critpath plane.
        from gtopkssgd_tpu_torch.obs import critpath as _critpath
        lanes_seen: set = set()
        for step in sorted(crit_by_step):
            per_rank = crit_by_step[step]
            res = _critpath.critical_path(
                {r: rec["segments"] for r, rec in per_rank.items()})
            chain = res.get("chain", [])
            for r in sorted(per_rank):
                rec = per_rank[r]
                tid = 100 + r  # one stage lane per rank, after tid 0
                if tid not in lanes_seen:
                    lanes_seen.add(tid)
                    events.append({
                        "ph": "M", "name": "thread_name", "pid": 0,
                        "tid": tid,
                        "args": {"name": f"critpath rank {r}"}})
                # Anchor: the record lands when the step's capture
                # ends, so the rank's window [0, wall] maps to
                # [time - wall, time] on the shared wall-clock axis.
                wall = float(rec.get("wall_us", 0.0))
                t_end = float(rec["time"]) * 1e6
                for seg in rec["segments"]:
                    t0 = float(seg.get("t0_us", 0.0))
                    t1 = float(seg.get("t1_us", 0.0))
                    if t1 <= t0:
                        continue
                    critical = any(
                        p["rank"] == r and p["stage"] == seg.get("stage")
                        and min(float(p["t1_us"]), t1)
                        - max(float(p["t0_us"]), t0) > 1e-6
                        for p in chain)
                    body.append({
                        "ph": "X", "name": str(seg.get("stage")),
                        "cat": "critpath",
                        "ts": t_end - wall + t0, "dur": t1 - t0,
                        "pid": 0, "tid": tid,
                        "args": {"step": step, "critical": critical,
                                 "crit_stage": res.get("crit_stage")},
                    })
    # ---- per-link lanes: each linkmap record's carved per-round
    # intervals (obs/linkmap.py) become duration events on one lane per
    # (axis, peer-pair) link, anchored like the critpath lanes so the
    # observing rank's comm window ends at the record's wall time — the
    # Perfetto view of WHICH hop each round's time went to.
    # Link lanes allocate above the per-rank stage lanes, which occupy
    # [100, 100 + max rank]: a fixed 200 base aliased lanes on fleets
    # with >= 100 ranks (rank 100's stage lane IS tid 200).
    _max_rank = max((r for per_rank in crit_by_step.values()
                     for r in per_rank), default=-1)
    link_base = max(200, 101 + _max_rank)
    link_tids: Dict[str, int] = {}
    for rec in records:
        if (rec.get("kind") != "linkmap"
                or not isinstance(rec.get("time"), (int, float))
                or not isinstance(rec.get("rounds"), list)):
            continue
        rounds = [rd for rd in rec["rounds"]
                  if isinstance(rd, dict)
                  and isinstance(rd.get("t_ms"), (int, float))
                  and not isinstance(rd.get("t_ms"), bool)]
        total_us = sum(float(rd["t_ms"]) for rd in rounds) * 1e3
        t_cursor = float(rec["time"]) * 1e6 - total_us
        for rd in rounds:
            dur = float(rd["t_ms"]) * 1e3
            try:
                lo, hi = sorted((int(rd.get("src")), int(rd.get("dst"))))
            except (TypeError, ValueError):
                t_cursor += dur
                continue
            key = f"{rd.get('axis', '?')}:{lo}-{hi}"
            tid = link_tids.get(key)
            if tid is None:
                tid = link_tids[key] = link_base + len(link_tids)
                events.append({
                    "ph": "M", "name": "thread_name", "pid": 0,
                    "tid": tid, "args": {"name": f"link {key}"}})
            if dur > 0:
                body.append({
                    "ph": "X", "name": key, "cat": "linkmap",
                    "ts": t_cursor, "dur": dur, "pid": 0, "tid": tid,
                    "args": {"step": rec.get("step"),
                             "round": rd.get("round"),
                             "rank": rec.get("rank", 0),
                             "axis": rd.get("axis")},
                })
            t_cursor += dur
    for rec in records:
        kind = rec.get("kind")
        ts = rec.get("time")
        if not isinstance(ts, (int, float)):
            continue
        ts_us = float(ts) * 1e6
        if kind in _COUNTER_KINDS:
            vals = {f: float(rec[f]) for f in _COUNTER_KINDS[kind]
                    if isinstance(rec.get(f), (int, float))
                    and not isinstance(rec.get(f), bool)
                    and float(rec[f]) == float(rec[f])}
            if vals:
                body.append({"ph": "C", "name": kind, "ts": ts_us,
                             "pid": 0, "tid": 0, "args": vals})
            if kind == "goodput":
                # Badput track: cumulative seconds per category
                # (obs/goodput.py taxonomy) as one stacked counter —
                # the Perfetto view of WHERE non-productive wall
                # accrues over the run.
                from gtopkssgd_tpu_torch.obs import goodput as _goodput
                bad = {c: float(rec[f"{c}_s"])
                       for c in _goodput.BADPUT + ("other",)
                       if isinstance(rec.get(f"{c}_s"), (int, float))
                       and not isinstance(rec.get(f"{c}_s"), bool)}
                if bad:
                    body.append({"ph": "C", "name": "badput_s",
                                 "ts": ts_us, "pid": 0, "tid": 0,
                                 "args": bad})
        elif kind in _MARKER_KINDS:
            name = (f"{kind}:{rec.get('rule', '?')}" if kind == "event"
                    else kind)
            args = {k: v for k, v in rec.items()
                    if k in ("rule", "severity", "step", "value",
                             "threshold", "message")}
            body.append({"ph": "i", "s": "p", "name": name, "cat": "marker",
                         "ts": ts_us, "pid": 0, "tid": 0, "args": args})
    body.sort(key=lambda e: e["ts"])
    return {"traceEvents": events + body, "displayTimeUnit": "ms"}


def validate_timeline(doc: dict) -> List[str]:
    """Chrome-trace schema check: required keys per phase type and
    globally monotonic non-metadata timestamps. Returns problem strings
    (empty = valid)."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    last_ts = None
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph is None or "name" not in e or "pid" not in e:
            problems.append(f"event {i}: missing ph/name/pid")
            continue
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i} ({e.get('name')}): missing ts")
            continue
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(
                    f"event {i} ({e.get('name')}): X without dur >= 0")
        if last_ts is not None and ts < last_ts:
            problems.append(
                f"event {i} ({e.get('name')}): ts not monotonic "
                f"({ts} < {last_ts})")
        last_ts = ts
    return problems
