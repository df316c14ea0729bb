"""Trace attribution, the port of ``gtopkssgd_tpu/obs/trace_attr.py``:
the paper's T_compute / T_select / T_comm split of a step, read from a
``torch.profiler`` Chrome trace (Kineto's export) where the JAX package
reads a ``jax.profiler`` trace.

Lanes. An event's ``cat`` says where it ran:

  kernel, gpu_memcpy, gpu_memset   device work on a CUDA stream lane
  gpu_user_annotation              a ``record_function`` range as the
                                   card saw it (first to last kernel it
                                   launched)
  cpu_op                           an ATen op (or c10d call) on the host
  user_annotation                  a ``record_function`` range on the host

A trace with device work is attributed on the card's lanes (op events:
the kernels, copies and memsets). A range's device time there is the self
time of the kernels launched inside it: the runtime call that launched a
kernel (``cuda_runtime``, tied to it by its correlation id) lies in the
range on the launching thread. That ties the selection's kernels to
"select", and leaves out of "forward_backward" the backward kernels
autograd's device thread launches, so compute falls back to the op
classifier where the ranges cover too little of it (``gpu_user_annotation``
events, first to last kernel of a range on its own thread, would count
the forward alone and the gaps in it; a trace without launch records uses
them). A trace with no device work (the CPU) is attributed on the host,
which then is the device (op events: ``cpu_op``; span events:
``user_annotation``).

Two sources a class, chosen per class as in the JAX module:

  spans  the trainer's and the optimizer's ranges (``Tracer`` spans
      "forward_backward", "optimizer", torch's "Optimizer.step#...", the
      optimizer's "select" and "exchange"), by name (``classify_span``,
      whole-word tokens: "select" -> select; "exchange" and the
      collectives -> comm; "forward_backward", "optimizer" -> compute).
      The port's container ranges ("dispatch", "data", "obs_read") name
      no class. On the card a class's span time is the kernels launched
      in its ranges (the innermost classified range holding the launch);
      elsewhere a range's SELF time on its lane (its length less the
      ranges nested in it), so nested ranges partition the step instead
      of counting it twice.
  ops  the op classifier (``classify_op``) over op events: the port's
      selection kernels (``stage1_kernel``, ``multisection_kernel``,
      ``count_kernel``) and torch's sort and top-k (the radix sort and
      ``sbtopk`` kernels on the card, ``aten::topk``/``aten::sort`` on
      the CPU; the merge's stable sort and the quantized codec's sort
      among them) -> select; NCCL's kernels (``ncclDevKernel_*``,
      ``ncclKernel_*``) and the host's c10d/gloo calls -> comm;
      everything else -> compute. Self times, resolved per lane.

A class uses its spans when they exist and cover at least
``min_span_coverage`` of its op time (or no op of it was seen); ``source``
is "spans", "ops" or "mixed" over the classes with data. A CUDA graph's
replay carries no ranges, so a graph dispatch is attributed on kernel
names alone ("ops"), and K2's replayed launches still land in select.

Host comm. With gloo (the CPU, or P ranks sharing one card) the wire is
staged through the host (``parallel.collectives._ship``), so its time is
host time: the c10d calls (``cpu_op`` "c10d::...") and gloo's own ranges
("gloo:send", "gloo:recv", "gloo:all_reduce", on any thread). When the
trace has no NCCL kernel, comm is the wall-clock union of those host
events (``comm_source`` = "host"); with NCCL it is the device's
(``comm_source`` = "device"; "none" without any comm).

``overlap_frac``: the wall-clock union of comm intersected with the
union of the other classes' intervals, over the comm union -- the share
of comm hidden under other work (0 on a serial schedule).
``stage_intervals=True`` also attaches the compact per-step stage record
(``obs.critpath``) built from the same intervals.

``capture()`` profiles a block with the options ``profile_step`` uses
(CPU and CUDA activity, every thread, no Python stack, no shapes) and
writes ``rank{r}.trace.json``; ``profiler()`` is that profiler.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

# ------------------------------------------------------------ classifiers

# Substrings of a lowercased op name (a demangled kernel name or an ATen
# op) that make it a selection op.
_SELECT_PATTERNS = ("stage1_kernel", "multisection_kernel", "count_kernel",
                    "topk", "sort")
# Prefixes of a lowercased op name that make it a comm op: NCCL's kernels
# on the card, the c10d calls and gloo's ranges on the host.
_DEVICE_COMM_PREFIXES = ("nccldevkernel", "ncclkernel")
_HOST_COMM_PREFIXES = ("c10d::", "gloo:")

# Whole-word tokens of a range name, by class, checked in this order.
_SPAN_BUCKET_TOKENS = (
    ("select", ("select", "compress", "topk", "top_k")),
    ("comm", ("exchange", "comm", "allreduce", "all_reduce", "allgather",
              "gloo", "nccl")),
    ("compute", ("forward_backward", "optimizer", "apply", "fwd", "bwd")),
)

TERMS = ("compute", "select", "comm")

DEVICE_OP_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_SPAN_CAT = "gpu_user_annotation"
HOST_OP_CAT = "cpu_op"
HOST_SPAN_CAT = "user_annotation"


def classify_op(name: str) -> str:
    """Bucket one op name: 'select' | 'comm' | 'compute'."""
    n = name.lower()
    if n.startswith(_DEVICE_COMM_PREFIXES + _HOST_COMM_PREFIXES):
        return "comm"
    if any(p in n for p in _SELECT_PATTERNS):
        return "select"
    return "compute"


def classify_span(path: str) -> Optional[str]:
    """Bucket a range name or span path ("dispatch/select" -> 'select');
    None when no token names a class (container ranges such as
    "dispatch" or "data" must not pollute the split)."""
    tokens = set(re.split(r"[^a-z0-9_]+", path.lower()))
    for bucket, toks in _SPAN_BUCKET_TOKENS:
        if tokens.intersection(toks):
            return bucket
    return None


def is_host_comm(name: str) -> bool:
    """A host event of a collective: a c10d call or a gloo range."""
    return str(name).lower().startswith(_HOST_COMM_PREFIXES)


# -------------------------------------------------------------- trace IO

def find_trace_file(path: str) -> str:
    """A trace file, or the newest ``*.trace.json[.gz]`` under a
    directory (``capture``'s and ``--profile-dir``'s layout)."""
    if os.path.isfile(path):
        return path
    paths = glob.glob(os.path.join(path, "**", "*.trace.json.gz"),
                      recursive=True)
    paths += glob.glob(os.path.join(path, "**", "*.trace.json"),
                       recursive=True)
    if not paths:
        raise FileNotFoundError(f"no chrome trace found under {path}")
    return max(paths, key=os.path.getmtime)


def load_trace(path: str) -> dict:
    """Load a Chrome-trace JSON document (plain or gzipped)."""
    path = find_trace_file(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh)


def trace_lanes(events: List[dict]) -> Tuple[str, Tuple[str, ...], str]:
    """(where, op categories, span category): the card's lanes when the
    trace holds device work, else the host's."""
    if any(e.get("ph") == "X" and e.get("cat") in DEVICE_OP_CATS
           for e in events):
        return "device", DEVICE_OP_CATS, DEVICE_SPAN_CAT
    return "host", (HOST_OP_CAT,), HOST_SPAN_CAT


def self_durations_us(events: List[dict]) -> List[float]:
    """Self time (dur minus same-lane nested children) per event, in the
    input order. The caller groups events by lane; the nesting is
    resolved with a (ts, -end) stack sweep."""
    order = sorted(
        range(len(events)),
        key=lambda i: (float(events[i].get("ts", 0.0)),
                       -(float(events[i].get("ts", 0.0))
                         + float(events[i].get("dur", 0.0)))))
    selfs = [0.0] * len(events)
    stack: List[List] = []  # [end_ts, child_dur_sum, index]
    for i in order:
        e = events[i]
        ts = float(e.get("ts", 0.0))
        dur = float(e.get("dur", 0.0))
        while stack and ts >= stack[-1][0] - 1e-9:
            end, child, j = stack.pop()
            selfs[j] = max(0.0, float(events[j].get("dur", 0.0)) - child)
        if stack:
            stack[-1][1] += dur
        stack.append([ts + dur, 0.0, i])
    while stack:
        end, child, j = stack.pop()
        selfs[j] = max(0.0, float(events[j].get("dur", 0.0)) - child)
    return selfs


# ------------------------------------------------------------ attribution

def _interval_union(intervals: List[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """Merge (start, end) intervals into a sorted disjoint union."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of `intervals`."""
    return sum(e - s for s, e in _interval_union(list(intervals)))


def _intersection_us(a: List[Tuple[float, float]],
                     b: List[Tuple[float, float]]) -> float:
    """Total overlap length of two disjoint sorted interval unions."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_length(intervals: List[Tuple[float, float]],
                   windows: List[Tuple[float, float]]) -> float:
    """How much of the union of `intervals` lies inside the union of
    `windows`."""
    return _intersection_us(_interval_union(list(intervals)),
                            _interval_union(list(windows)))


def overlap_fraction(comm_iv: List[Tuple[float, float]],
                     other_iv: List[Tuple[float, float]]) -> float:
    """Fraction of the comm wall-clock union hidden under non-comm work:
    |union(comm) & union(other)| / |union(comm)|; 0.0 without comm."""
    comm_u = _interval_union(comm_iv)
    comm_len = sum(e - s for s, e in comm_u)
    if comm_len <= 0:
        return 0.0
    return _intersection_us(comm_u, _interval_union(other_iv)) / comm_len


def _by_lane(events: Iterable[dict]) -> Dict[Tuple, List[dict]]:
    lanes: Dict[Tuple, List[dict]] = collections.defaultdict(list)
    for e in events:
        lanes[(e.get("pid"), e.get("tid"))].append(e)
    return lanes


def _launch_classes(events: List[dict]) -> Dict[object, Optional[str]]:
    """{correlation id: the class of the innermost classified host range
    (``classify_span``) holding the launch, on the launching thread, or
    None}: the runtime calls (``cuda_runtime``, ``cuda_driver``) that
    launched the device work, tied to it by their correlation id."""
    ranges: Dict[Tuple, List[Tuple[float, float, str]]] = (
        collections.defaultdict(list))
    for e in events:
        if e.get("cat") == HOST_SPAN_CAT:
            cls = classify_span(str(e.get("name", "")))
            if cls is not None:
                ts = float(e.get("ts", 0.0))
                ranges[(e.get("pid"), e.get("tid"))].append(
                    (ts, ts + float(e.get("dur", 0.0)), cls))
    out: Dict[object, Optional[str]] = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") not in LAUNCH_CATS or corr is None:
            continue
        t = float(e.get("ts", 0.0))
        best = None
        for start, end, cls in ranges.get((e.get("pid"), e.get("tid")), ()):
            if start <= t <= end and (best is None or start >= best[0]):
                best = (start, cls)
        out[corr] = None if best is None else best[1]
    return out


def attribute(trace, mode: Optional[str] = None,
              min_span_coverage: float = 0.5,
              stage_intervals: bool = False,
              wire_us: Optional[float] = None) -> dict:
    """The paper's decomposition from a Chrome trace (a capture dir, a
    trace file, or a loaded document). Returns a flat record (callers log
    it as kind="attr"): t_{compute,select,comm}_us, frac_* over their sum,
    the per-class source (``source_{term}``: "spans" | "ops", comm also
    "host") and the overall ``source``, ``comm_source`` ("device" |
    "host" | "none"), ``lanes`` ("device" | "host"), ``overlap_frac``, the
    event counts and the top ops a class (strings).

    ``stage_intervals=True`` also attaches ``rec["critpath"]``: the
    per-step stage record (``obs.critpath``) of the same intervals, the
    comm span wait-split against ``wire_us`` (None: the whole comm span
    stays comm)."""
    trace_file = None
    if isinstance(trace, str):
        trace_file = find_trace_file(trace)
        doc = load_trace(trace_file)
    else:
        doc = trace
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    where, op_cats, span_cat = trace_lanes(events)

    op_us = {t: 0.0 for t in TERMS}
    op_top: Dict[str, Dict[str, float]] = {t: collections.defaultdict(float)
                                           for t in TERMS}
    # Raw wall intervals a class across every lane (the overlap wants
    # the concurrency of two lanes, which self times erase); each op's
    # interval is its self time anchored at its start.
    op_iv: Dict[str, List[Tuple[float, float]]] = {t: [] for t in TERMS}
    select_ops: Dict[str, int] = collections.Counter()
    span_us = {t: 0.0 for t in TERMS}
    span_iv: Dict[str, List[Tuple[float, float]]] = {t: [] for t in TERMS}
    n_ops = n_spans = 0
    launched = _launch_classes(events) if where == "device" else {}
    for lane_events in _by_lane(e for e in events
                                if e.get("cat") in op_cats).values():
        for e, us in zip(lane_events, self_durations_us(lane_events)):
            name = e.get("name", "?")
            bucket = classify_op(name)
            op_us[bucket] += us
            op_top[bucket][name] += us
            if bucket == "select":
                select_ops[name[:96]] += 1
            ts = float(e.get("ts", 0.0))
            if us > 0:
                op_iv[bucket].append((ts, ts + us))
            n_ops += 1
            # The class of the range the kernel was launched in.
            ranged = launched.get(e.get("args", {}).get("correlation"))
            if ranged is not None:
                span_us[ranged] += us
                if us > 0:
                    span_iv[ranged].append((ts, ts + us))
                n_spans += 1

    if not launched:  # no launch records: the span events' own times
        for lane_events in _by_lane(e for e in events
                                    if e.get("cat") == span_cat).values():
            for e, us in zip(lane_events, self_durations_us(lane_events)):
                bucket = classify_span(str(e.get("name", "")))
                if bucket is None:
                    continue
                span_us[bucket] += us
                ts = float(e.get("ts", 0.0))
                if us > 0:
                    span_iv[bucket].append((ts, ts + us))
                n_spans += 1

    use_spans_t = {
        t: (span_us[t] > 0
            and (op_us[t] == 0
                 or span_us[t] >= min_span_coverage * op_us[t]))
        for t in TERMS}
    chosen = {t: span_us[t] if use_spans_t[t] else op_us[t] for t in TERMS}
    src = {t: "spans" if use_spans_t[t] else "ops" for t in TERMS}
    iv = op_iv if n_ops > 0 else span_iv

    # Host-staged comm: without an NCCL kernel, comm is the host's.
    host_iv = [(float(e.get("ts", 0.0)),
                float(e.get("ts", 0.0)) + float(e.get("dur", 0.0)))
               for e in events if e.get("cat") in (HOST_OP_CAT, HOST_SPAN_CAT)
               and is_host_comm(e.get("name", ""))]
    nccl = where == "device" and op_us["comm"] > 0
    if host_iv and not nccl:
        comm_source = "host"
        iv = {**iv, "comm": _interval_union(host_iv)}
        chosen["comm"] = union_length(host_iv)
        src["comm"] = "host"
    else:
        comm_source = "device" if chosen["comm"] > 0 else "none"
    total = sum(chosen.values())
    votes = [use_spans_t[t] for t in TERMS if src[t] != "host"
             and (span_us[t] > 0 or op_us[t] > 0)]
    source = ("spans" if votes and all(votes)
              else "ops" if not any(votes) else "mixed")
    ofrac = overlap_fraction(
        iv["comm"], [x for t in TERMS if t != "comm" for x in iv[t]])

    rec = {}
    if stage_intervals:
        # critpath imports this module at its top for the interval
        # algebra; this edge stays call-time only.
        from gtopkssgd_tpu_torch.obs import critpath
        budget = float("inf") if wire_us is None else float(wire_us)
        fine = critpath.stage_segments(iv, budget, fill_gaps=True)
        rec["critpath"] = critpath.build_record(
            critpath.coarsen(fine, min_us=500.0),
            totals=critpath.stage_totals(fine))
    rec = {
        **rec,
        "mode": mode,
        "source": source,
        "lanes": where,
        "comm_source": comm_source,
        "n_op_events": n_ops,
        "n_span_events": n_spans,
        "t_total_us": round(total, 1),
        "overlap_frac": round(ofrac, 6),
    }
    if trace_file is not None:
        rec["trace_file"] = trace_file
    for t in TERMS:
        rec[f"t_{t}_us"] = round(chosen[t], 1)
        rec[f"frac_{t}"] = round(chosen[t] / total, 6) if total else 0.0
        rec[f"source_{t}"] = src[t]
    for t in TERMS:
        rows = sorted(op_top[t].items(), key=lambda kv: -kv[1])[:3]
        rec[f"top_{t}_ops"] = ", ".join(
            f"{n[:48]}={us / 1e3:.2f}ms" for n, us in rows)
    rec["select_ops"] = dict(sorted(select_ops.items()))
    return rec


def host_span_means(trace) -> Dict[str, float]:
    """Mean us per host range name (the Tracer's view of the same names,
    for correlating against the device split)."""
    doc = load_trace(trace) if isinstance(trace, str) else trace
    acc: Dict[str, List[float]] = collections.defaultdict(list)
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") != HOST_SPAN_CAT:
            continue
        name = str(e.get("name", ""))
        if classify_span(name) is not None or "/" in name:
            acc[name].append(float(e.get("dur", 0.0)))
    return {n: sum(v) / len(v) for n, v in acc.items() if v}


def op_ranking(trace, top: int = 40) -> dict:
    """The ops of the trace's attribution lanes ranked by total time:
    {trace_file, lanes, attributed_op_us_total, class_us, top_ops}."""
    trace_file = find_trace_file(trace) if isinstance(trace, str) else None
    doc = load_trace(trace_file) if trace_file else trace
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    where, op_cats, _ = trace_lanes(events)
    agg: Dict[str, float] = collections.defaultdict(float)
    count: Dict[str, int] = collections.defaultdict(int)
    for lane_events in _by_lane(e for e in events
                                if e.get("cat") in op_cats).values():
        for e, us in zip(lane_events, self_durations_us(lane_events)):
            agg[e.get("name", "?")] += us
            count[e.get("name", "?")] += 1
    total = sum(agg.values())
    by_class: Dict[str, float] = collections.defaultdict(float)
    for name, us in agg.items():
        by_class[classify_op(name)] += us
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    return {
        "trace_file": trace_file,
        "lanes": where,
        "attributed_op_us_total": round(total, 1),
        "class_us": {k: round(v, 1) for k, v in sorted(by_class.items())},
        "top_ops": [
            {"name": n[:160], "total_us": round(us, 1), "calls": count[n],
             "class": classify_op(n),
             "pct": round(100 * us / total, 2) if total else None}
            for n, us in rows],
    }


# ---------------------------------------------------------------- capture

def profiler():
    """A ``torch.profiler`` of CPU activity (and CUDA activity where a
    card is visible) on every thread of the process, the optimizer's
    merge thread included; no Python stack, no shapes."""
    import torch
    from torch._C._profiler import _ExperimentalConfig

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts, acc_events=True,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))


def trace_path(log_dir: str, rank: int = 0) -> str:
    """Where ``capture`` writes rank `rank`'s trace in `log_dir`."""
    return os.path.join(log_dir, f"rank{int(rank)}.trace.json")


@contextmanager
def capture(log_dir: str, rank: int = 0):
    """Profile the block (``profiler()``) and write its Chrome trace to
    ``trace_path(log_dir, rank)``; yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    with profiler() as prof:
        yield prof
    prof.export_chrome_trace(trace_path(log_dir, rank))


def format_attr(rec: dict) -> str:
    """Render one attr record as the paper's decomposition table."""
    header = ["term", "time_ms", "frac", "src"]
    rows = []
    for t in TERMS:
        us = float(rec.get(f"t_{t}_us", 0.0))
        rows.append([f"T_{t}", f"{us / 1e3:.3f}",
                     f"{float(rec.get(f'frac_{t}', 0.0)):.4f}",
                     str(rec.get(f"source_{t}", rec.get("source", "?")))])
    widths = [max(len(r[i]) for r in [header] + rows)
              for i in range(len(header))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths))
             for r in [header, ["-" * w for w in widths]] + rows]
    head = (f"[attr] source={rec.get('source')}"
            + (f"  mode={rec['mode']}" if rec.get("mode") else "")
            + f"  comm={rec.get('comm_source')}"
            + f"  total={float(rec.get('t_total_us', 0.0)) / 1e3:.3f}ms"
            + f"  op_events={rec.get('n_op_events')}"
            + (f"  overlap_frac={float(rec['overlap_frac']):.4f}"
               if rec.get("overlap_frac") is not None else ""))
    tops = [f"  top {t}: {rec[f'top_{t}_ops']}"
            for t in TERMS if rec.get(f"top_{t}_ops")]
    return "\n".join([head] + lines + tops)
