"""Tracing spans, the port of ``gtopkssgd_tpu/obs/tracing.py``: one name,
two timelines.

A ``Tracer.span("data")`` adds

  * a host-side duration to a ``TimingStats`` accumulator under the span's
    nested path (and optionally a per-span metrics record), and
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
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch
from torch.profiler import record_function


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
                 enabled: bool = True, record_each: bool = False,
                 sink=None):
        """``metrics`` is a ``utils.metrics.MetricsLogger`` (or anything
        with ``.log(kind, **fields)``). ``record_each=True`` writes one
        "span" record a span; the default accumulates into ``stats`` and
        ships the means through ``flush()``. ``sink`` is called as
        ``sink(path, t0_perf_counter, seconds)`` on every span's close
        (``obs.timeline.TimelineRecorder.span_sink``)."""
        self.stats = stats or TimingStats()
        self.metrics = metrics
        self.enabled = enabled
        self.record_each = record_each
        self.sink = sink
        self._local = threading.local()
        self._nvtx = torch.cuda.is_available()  # NVTX needs a card

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @property
    def current_path(self) -> str:
        return "/".join(self._stack())

    @contextmanager
    def span(self, name: str, *, sync: bool = False, **attrs):
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
                if self.record_each and self.metrics is not None:
                    self.metrics.log("span", name=name, path=path,
                                     dur_s=dur, **attrs)

    def annotate(self, name: Optional[str] = None):
        """Decorator form: every call of the wrapped function runs inside
        a span."""

        def deco(fn):
            label = name or fn.__name__

            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                with self.span(label):
                    return fn(*args, **kwargs)

            return wrapped

        return deco

    def flush(self, step: Optional[int] = None) -> Dict[str, float]:
        """Ship the accumulated mean seconds a path as ONE "spans" record
        and reset, so each logging window reports its own means. Returns
        the summary logged."""
        summary = self.stats.summary()
        if summary and self.metrics is not None:
            rec = {} if step is None else {"step": step}
            rec.update({path: round(sec, 6) for path, sec in summary.items()})
            self.metrics.log("spans", **rec)
        self.stats.reset()
        return summary
