"""Observability of a training run, the port of ``gtopkssgd_tpu/obs``'s
anomaly core, its host planes (ROADMAP item 7b), the trace planes one
rank runs live in its own train loop (item 7c, first half):

  counters.py    on-device training-health counters of the compression
                 pipeline (achieved density, tau, grad/residual norms,
                 wire bytes, mass capture; per layer with the residual
                 age; the exact-top-k recall audit), computed inside the
                 optimizer's step and read once a dispatch.
  tracing.py     ``Tracer`` spans: host timing and a profiler/NVTX range
                 under one name, flushed as "spans" records; device-clock
                 marks that split the card's idle between dispatches
                 into the host's staging and its tail.
  watchdog.py    ``StallWatchdog``: a monitor thread that exits 43 with a
                 "stall" record when a dispatch makes no progress.
  events.py      ``AnomalyMonitor``: rules over the loss, the counters and
                 the planes below, "event" records, ``AnomalyHalt``
                 (exit 44).
  timeline.py    the host timeline as a Chrome-trace JSON.
  exporter.py    the latest metric values as OpenMetrics text on a
                 localhost port.
  goodput.py     the goodput ledger: the run's wall split into goodput and
                 a closed badput taxonomy, conserved (on by default).
  trace_attr.py  the T_compute / T_select / T_comm split of a
                 ``torch.profiler`` trace (kernel names, ranges, and the
                 host's gloo calls), its overlap share, and ``capture``.
  critpath.py    per-step stage segments, the comm span split into wire
                 and wait, and the cross-rank critical path.
  ledger.py      measured comm time and wire bytes against the planner's
                 alpha-beta model.
  calib.py       the live comm-model fit and its ``calib_fit`` file.
  linkmap.py     the per-(link class, peer) weather map.
  memwatch.py    the compile and memory watch on the CUDA caching
                 allocator.
  forecast.py    the hindcast and the scale-out forecast, priced with the
                 card's comm fits (a "forecast" record a capture).

and the planes that read beyond one run (item 7c, second half), offline
over the record files:

  fleet.py       the ranks' shards merged: cross-rank rows, the
                 stragglers (``straggler_persistent``), the global
                 critical path, the goodput by rank (the eviction check's
                 view, ``resilience.elastic.eviction_decision``).
  registry.py    one summary line a run in ``runs.jsonl``; ``history``
                 and ``regress``.
  report.py      ``python -m gtopkssgd_tpu_torch.obs.report``: the
                 summary, ``gate``, and a view of each plane.
"""

from gtopkssgd_tpu_torch.obs import counters
from gtopkssgd_tpu_torch.obs.counters import LAYER_FIELDS, TELEMETRY_FIELDS
from gtopkssgd_tpu_torch.obs.events import (
    HALT_EXIT_CODE,
    RULES,
    AnomalyHalt,
    AnomalyMonitor,
    Thresholds,
)
from gtopkssgd_tpu_torch.obs.exporter import MetricsExporter
from gtopkssgd_tpu_torch.obs.timeline import (
    TimelineRecorder,
    timeline_from_records,
    validate_timeline,
)
from gtopkssgd_tpu_torch.obs.tracing import TimingStats, Tracer
from gtopkssgd_tpu_torch.obs.watchdog import STALL_EXIT_CODE, StallWatchdog

__all__ = [
    "HALT_EXIT_CODE",
    "LAYER_FIELDS",
    "RULES",
    "STALL_EXIT_CODE",
    "TELEMETRY_FIELDS",
    "AnomalyHalt",
    "AnomalyMonitor",
    "MetricsExporter",
    "StallWatchdog",
    "Thresholds",
    "TimelineRecorder",
    "TimingStats",
    "Tracer",
    "counters",
    "timeline_from_records",
    "validate_timeline",
]
