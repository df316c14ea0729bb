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
``validate_timeline`` is the schema check. The JAX package's critical-path,
link and badput lanes come from planes the port does not have yet.

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
# each contributes (a missing field is skipped).
_COUNTER_KINDS = {
    "train": ("loss", "throughput"),
    "obs": ("achieved_density", "residual_norm", "grad_norm_post", "tau"),
}
_MARKER_KINDS = ("event", "stall")


def timeline_from_records(records: List[dict],
                          label: str = "run") -> dict:
    """Rebuild a coarse timeline from metrics records: counter samples for
    the train/obs numbers and instant markers for event/stall records, at
    their recorded wall-clock times. Span durations are not rebuilt (the
    records carry window means, not start times): ``--obs-timeline`` keeps
    the live span view."""
    events: List[dict] = [{
        "ph": "M", "name": "process_name", "pid": 0,
        "args": {"name": f"host {label} (from metrics.jsonl)"},
    }, {
        "ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
        "args": {"name": "records"},
    }]
    body: List[dict] = []
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
