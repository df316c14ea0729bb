"""Tracing spans, the port of ``gtopkssgd_tpu/obs/tracing.py``: one name,
two timelines.

A ``Tracer.span("data")`` adds

  * a host-side duration to a ``TimingStats`` accumulator under the span's
    nested path, and
  * a ``torch.profiler.record_function`` range and, on a CUDA build with a
    card, an NVTX range, both carrying the span's own name,

where the JAX package opens a ``jax.profiler.TraceAnnotation``. The
profiler range keeps the span's own name, not its nested path, because
``profile_step`` and ``benchmark`` read the trainer's ranges by name
("data", "forward_backward", "optimizer"); the host statistics, the
"spans" records and the timeline carry the path.

Spans nest: ``span("dispatch")`` holding ``span("optimizer")`` adds under
``"dispatch/optimizer"``. Nesting is tracked per thread, so the prefetch
thread's spans never land in the training thread's path.

Device-clock marks. A ``Tracer`` given a CUDA ``device`` records a
timing ``torch.cuda.Event`` on the device's current stream at
``mark(name)``, taken from a small pool it reuses; it never
synchronizes, and records nothing while the stream captures a graph. A
mark recorded while the stream is idle completes at the host's moment;
one recorded while it is busy completes when the stream reaches it. So
the time between two marks on one stream is device idle time that
belongs to the host's phase between them. The trainer marks three points
of a dispatch: "data" as its staging opens, "first" just before its
first device work (the first host-to-device copy) and "end" after its
last device work before the read. At the dispatch's read, after the sync
it already pays, ``idle_split(steps)`` splits the gap since the previous
dispatch's "end" (``split_gap``): the part after staging opened is the
host's staging ("data"), the rest the host's tail (the previous
dispatch's bookkeeping and the caller's time between dispatches). Each
split goes, in seconds a step, to the module's bounded record ``idle``
(the last ``IDLE_RECORD`` dispatches, emptied when a ``Trainer`` is
built) and to the window that ``flush()`` ships as the "spans" keys
``device_idle/data`` and ``device_idle/tail``. Device work between two
dispatches (an evaluation) counts in the next gap's tail.

Staging counts. The trainer notes each dispatch its prefetcher grouped
(``note_stage``): its steps, whether it came staged in a ring slot
(``utils.staging``) and the seconds the main thread waited on the
prefetch worker for it. Where any dispatch of the window came from the
ring, ``flush()`` ships the share that did (``staging/ring_share``) and
the wait in seconds a step (``staging/wait``).
"""

from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager
from typing import Deque, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

IDLE_RECORD = 512
#: The last IDLE_RECORD dispatches' device idle split, (steps,
#: idle_data_s, idle_tail_s) each, seconds a step.
idle: Deque[Tuple[int, float, float]] = collections.deque(maxlen=IDLE_RECORD)


def split_gap(end_prev: Optional[float], data: float, first: float,
              steps: int) -> Optional[Tuple[float, float]]:
    """(idle_data_s, idle_tail_s), seconds a step, of the device's gap
    between the previous dispatch's "end" mark and this dispatch's
    "first", given the marks' times in seconds on one clock: the part of
    the gap after this dispatch's "data" mark (its staging) and the rest.
    A "data" mark before the previous "end" (staging overlapped with the
    device) leaves the whole gap to staging. None without a previous
    "end": a first dispatch."""
    if end_prev is None:
        return None
    gap = max(first - end_prev, 0.0)
    staged = min(max(first - max(data, end_prev), 0.0), gap)
    return staged / steps, (gap - staged) / steps


class TimingStats:
    """Seconds a phase, accumulated: the reference's timer dicts."""

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    def add(self, phase: str, seconds: float) -> None:
        self.totals[phase] += seconds
        self.counts[phase] += 1

    def mean(self, phase: str) -> float:
        c = self.counts[phase]
        return self.totals[phase] / c if c else 0.0

    def summary(self) -> Dict[str, float]:
        return {p: self.mean(p) for p in self.totals}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


class Tracer:
    def __init__(self, stats: Optional[TimingStats] = None, metrics=None,
                 enabled: bool = True, sink=None,
                 device: Optional[torch.device] = None):
        """``metrics`` is a ``utils.metrics.MetricsLogger`` (or anything
        with ``.log(kind, **fields)``): ``flush()`` ships the means
        accumulated in ``stats`` through it. ``sink`` is called as
        ``sink(path, t0_perf_counter, seconds)`` on every span's close
        (``obs.timeline.TimelineRecorder.span_sink``). A CUDA ``device``
        turns on the device-clock marks (``mark``, ``idle_split``)."""
        self.stats = stats or TimingStats()
        self.metrics = metrics
        self.enabled = enabled
        self.sink = sink
        self._local = threading.local()
        self._nvtx = torch.cuda.is_available()  # NVTX needs a card
        self._device = (device if device is not None
                        and device.type == "cuda" else None)
        self._pool: List[torch.cuda.Event] = []
        self._marks: Dict[str, torch.cuda.Event] = {}
        self._end: Optional[torch.cuda.Event] = None
        self._idle: List[Tuple[int, float, float]] = []  # since flush()
        self._stage: List[Tuple[int, bool, float]] = []  # since flush()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @property
    def current_path(self) -> str:
        return "/".join(self._stack())

    def mark(self, name: str) -> None:
        """Record the device-clock mark `name` on the device's current
        stream (replacing an unread one of that name); nothing without a
        CUDA device or while the stream captures a graph."""
        if self._device is None or torch.cuda.is_current_stream_capturing():
            return
        ev = (self._pool.pop() if self._pool
              else torch.cuda.Event(enable_timing=True))
        ev.record(torch.cuda.current_stream(self._device))
        old = self._marks.get(name)
        if old is not None:
            self._pool.append(old)
        self._marks[name] = ev

    def idle_split(self, steps: int) -> None:
        """At a dispatch of `steps` steps, after its read's device sync
        (every mark is complete): split the gap since the previous
        dispatch's "end" by this one's "data" and "first" marks
        (``split_gap``) into ``idle`` and the flush window, keep this
        dispatch's "end" for the next, and return the rest to the pool."""
        if self._device is None:
            return
        marks = [self._marks.pop(name, None) for name in ("data", "first")]
        prev, self._end = self._end, self._marks.pop("end", None)
        if prev is not None and None not in marks:
            data, first = (prev.elapsed_time(ev) / 1e3 for ev in marks)
            row = (steps,) + split_gap(0.0, data, first, steps)
            idle.append(row)
            self._idle.append(row)
        self._pool.extend(ev for ev in [prev] + marks if ev is not None)

    def note_stage(self, steps: int, ring: bool, wait_s: float) -> None:
        """A grouped dispatch of `steps` steps, staged from the ring or
        not, for which the main thread waited `wait_s` seconds."""
        self._stage.append((steps, ring, wait_s))

    @contextmanager
    def span(self, name: str, *, sync: bool = False):
        """Time a scope under ``name``, nested under the open spans.
        ``sync=True`` waits for the current CUDA device's queued work
        before the clock stops (leave it off for host phases, and for a
        dispatch whose device work must stay queued)."""
        if not self.enabled:
            yield
            return
        stack = self._stack()
        stack.append(name)
        path = "/".join(stack)
        nvtx = self._nvtx
        t0 = time.perf_counter()
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            with record_function(name):
                yield
        finally:
            try:
                if sync and torch.cuda.is_available():
                    torch.cuda.synchronize()
            finally:
                if nvtx:
                    torch.cuda.nvtx.range_pop()
                dur = time.perf_counter() - t0
                stack.pop()
                self.stats.add(path, dur)
                if self.sink is not None:
                    self.sink(path, t0, dur)

    def flush(self, step: Optional[int] = None) -> Dict[str, float]:
        """Ship the accumulated mean seconds a path, the window's device
        idle a step ("device_idle/data", "device_idle/tail", where
        ``idle_split`` recorded any) and its staging counts
        ("staging/ring_share", "staging/wait", where a dispatch came from
        the ring), as ONE "spans" record and reset, so each logging window
        reports its own means. Returns the summary logged."""
        summary = self.stats.summary()
        if self._idle:
            steps = sum(r[0] for r in self._idle)
            for i, key in ((1, "device_idle/data"), (2, "device_idle/tail")):
                summary[key] = sum(r[0] * r[i] for r in self._idle) / steps
        if any(r[1] for r in self._stage):
            summary["staging/ring_share"] = (
                sum(r[1] for r in self._stage) / len(self._stage))
            summary["staging/wait"] = (sum(r[2] for r in self._stage)
                                       / sum(r[0] for r in self._stage))
        if summary and self.metrics is not None:
            rec = {} if step is None else {"step": step}
            rec.update({path: round(sec, 6) for path, sec in summary.items()})
            self.metrics.log("spans", **rec)
        self.stats.reset()
        self._idle.clear()
        self._stage.clear()
        return summary
