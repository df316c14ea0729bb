"""Capturing a stretch of the window with ``torch.profiler`` and reading
it: device time a step by the program's ranges, host time a step by
range, the device's busy time, and the breakdown.

The rules are those of ``gtopkssgd_tpu_torch/obs/trace_attr.py``, copied
so that a change to the port cannot move them. Device work is the
events of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; each is
tied by its correlation id to the runtime call that launched it
(``cuda_runtime``, ``cuda_driver``). A range's device time is the union
of the device work launched inside one of its intervals on the host
(``user_annotation`` events of that name). Launches are matched by time
on any thread: autograd runs the backward on a device thread of its own
while the trainer's thread waits inside "forward_backward", and no other
thread of the port launches device work. Nested ranges count for each
range that holds them ("optimizer" holds "select" and "exchange").

The ranges read are ``RANGES``, the port's and the harness's, and those
that the cell's per-layer metrics declare (``cell_ranges``): a metric
that reads a new range of the program names it in its own module.

A traced run profiles one stretch of the window with host and device
activity (``summarize``): its dispatches are the harness's own ranges
"portbench_step", one a ``Trainer.train(K)`` call of K steps, each
ending in the trainer's device sync. Recording the host's ops slows an
eager step about threefold (ResNet-50 on an H100: 84 ms a step against
27.6), so the stretch's own length overstates the device's idle time:
its device times are the kernels' own durations, which the slowed host
leaves as they are, and the idle share divides them by the step time of
the window outside the stretch (``metrics/device_idle_frac.py``). The
breakdown's idle gaps are the slowed host's.

A CUDA graph's replay carries no ranges: its work is launched by one
graph launch. Its ranges come from the graph's capture (``graph_nodes``,
read from a profiled stretch that holds the capture, in set-up): while a
stream captures, each launch call records a node and runs nothing, so the
launch calls that put no work on the device are the graph's nodes in
order, each in the ranges that held it. A replay runs its nodes in that
order on one stream, so its i-th device operation is node i; a replay
whose count of operations differs from the nodes' is left unattributed.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench import spec

STEP_RANGE = "portbench_step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# Launch calls that put work on a stream (or, while it captures, a node
# into its graph); a graph's replay is launched by the other.
NODE_CALLS = ("Launch", "Memcpy", "Memset")
GRAPH_LAUNCH = "GraphLaunch"
HOST_RANGE_CAT = "user_annotation"
# The ranges the port opens (trainer.py, optimizer.py) and the harness's,
# read in every cell; a per-layer metric adds those it declares
# (``cell_ranges``).
RANGES = ("data", "dispatch", "forward_backward", "optimizer", "select",
          "exchange", "obs_read", STEP_RANGE)
TOP = 10


class Capture:
    """Profile the block of steps between ``start()`` and ``stop()``."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts,
                                           record_shapes=False,
                                           with_stack=False)
        self.prof.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def events(self) -> List[dict]:
        """The trace's complete events, through a Chrome trace written
        under the process's temporary directory and removed."""
        tmp = tempfile.mkdtemp(prefix="portbench-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                doc = json.load(fh)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.prof = None
        evs = doc["traceEvents"] if isinstance(doc, dict) else doc
        return [e for e in evs if e.get("ph") == "X"]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


class _Ranges:
    """The host intervals of one range name, for lookups by time."""

    def __init__(self, spans: List[Tuple[float, float]]):
        self.spans = sorted(spans)
        self.starts = [a for a, _ in self.spans]

    def holding(self, t: float) -> Optional[Tuple[float, float]]:
        """The interval holding time t; one name's intervals on the
        host never overlap."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i][1] >= t:
            return self.spans[i]
        return None


def cell_ranges(cell) -> Tuple[str, ...]:
    """The ranges a cell's trace is read by: ``RANGES`` and those that
    the cell's per-layer metrics declare (a module-level ``RANGES`` tuple
    of the metric's module), in that order."""
    names = list(RANGES)
    for m in cell.per_layer:
        for name in getattr(spec.metric(m["name"]), "RANGES", ()):
            if name not in names:
                names.append(name)
    return tuple(names)


def _parse(events: List[dict], ranges_read: Sequence[str] = RANGES):
    """(host ranges by name, launch calls by correlation id as (ts, name),
    device operations) of a trace's complete events; host ranges of the
    names in `ranges_read` only."""
    ranges: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(
        list)
    launch: Dict[int, Tuple[float, str]] = {}
    device: List[dict] = []
    for e in events:
        cat = e.get("cat")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat == HOST_RANGE_CAT and e.get("name") in ranges_read:
            ranges[e["name"]].append((ts, ts + dur))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[int(corr)] = (ts, str(e.get("name")))
        elif cat in DEVICE_CATS:
            device.append(e)
    return ranges, launch, device


def _holding(spans: Dict[str, "_Ranges"], t: float) -> frozenset:
    return frozenset(name for name, r in spans.items()
                     if r.holding(t) is not None)


def graph_nodes(events: List[dict], ranges_read: Sequence[str] = RANGES
                ) -> Optional[List[frozenset]]:
    """The ranges that held each node of the CUDA graph captured in a
    profiled stretch, in capture order; None where it holds no capture."""
    ranges, launch, device = _parse(events, ranges_read)
    ran = {int((e.get("args") or {}).get("correlation", -1))
           for e in device}
    spans = {name: _Ranges(v) for name, v in ranges.items()}
    nodes = sorted((ts, corr) for corr, (ts, name) in launch.items()
                   if corr not in ran and GRAPH_LAUNCH not in name
                   and any(w in name for w in NODE_CALLS))
    return [_holding(spans, ts) for ts, _ in nodes] or None


def summarize(events: List[dict], per_range: int = 1,
              nodes: Optional[List[frozenset]] = None,
              ranges_read: Sequence[str] = RANGES) -> Dict:
    """What the per-layer readers read from a profiled stretch: ``steps``
    captured (`per_range` a harness range, the dispatch's K), device ms a
    step and host ms a step by range of `ranges_read`, ``busy_s`` (the
    union of the device work inside the stretch) and ``window_s`` (the
    stretch), and the ``breakdown``; `nodes` attributes graph replays
    (``graph_nodes``, read with the same ranges)."""
    ranges, launch, device = _parse(events, ranges_read)
    steps = ranges.get(STEP_RANGE, [])
    if not steps or not device:
        return {"steps": 0}
    lo = min(a for a, _ in steps)
    hi = max(b for _, b in steps)
    spans = {name: _Ranges(v) for name, v in ranges.items()}
    by_range: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(
        list)
    ops = []
    by_name: Dict[str, float] = collections.defaultdict(float)
    replays: Dict[int, List[Tuple[float, float]]] = collections.defaultdict(
        list)
    for e in device:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        ops.append((ts, ts + dur))
        by_name[str(e.get("name"))[:120]] += dur
        corr = (e.get("args") or {}).get("correlation")
        call = launch.get(int(corr)) if corr is not None else None
        if call is None:
            continue
        if GRAPH_LAUNCH in call[1]:
            replays[int(corr)].append((ts, ts + dur))
            continue
        for name in _holding(spans, call[0]):
            by_range[name].append((ts, ts + dur))
    for work in replays.values():
        if nodes is None or len(work) != len(nodes):
            continue
        for iv, names in zip(sorted(work), nodes):
            for name in names:
                by_range[name].append(iv)
    n = len(steps) * per_range
    busy = _union(_clip(ops, lo, hi))
    device_ms = {name: _length(_union(v)) / 1e3 / n
                 for name, v in by_range.items()}
    host_ms = {name: _length(v) / 1e3 / n for name, v in ranges.items()}
    return {"steps": n, "device_ms": device_ms, "host_ms": host_ms,
            "busy_s": _length(busy) / 1e6, "window_s": (hi - lo) / 1e6,
            "replays": len(replays),
            "replays_attributed": sum(
                1 for w in replays.values()
                if nodes is not None and len(w) == len(nodes)),
            "breakdown": _breakdown(by_name, busy, lo, hi, spans)}


def _innermost(spans: Dict[str, _Ranges], t: float) -> str:
    best, start = "outside the program's ranges", -1.0
    for name, r in spans.items():
        if name == STEP_RANGE:
            continue
        got = r.holding(t)
        if got is not None and got[0] > start:
            best, start = name, got[0]
    return best


def _breakdown(by_name, busy, lo, hi, spans) -> Dict:
    """The device operations that took most time, and the device's idle
    time summed by the innermost program range the host was in when each
    idle gap began, in seconds."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle: Dict[str, float] = collections.defaultdict(float)
    edge = lo
    for a, b in busy + [(hi, hi)]:
        if a > edge:
            idle[_innermost(spans, edge)] += a - edge
        edge = max(edge, b)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v / 1e6] for k, v in top],
            "idle_gaps": [[k, v / 1e6] for k, v in gaps]}


@contextlib.contextmanager
def step_range():
    with torch.profiler.record_function(STEP_RANGE):
        yield
