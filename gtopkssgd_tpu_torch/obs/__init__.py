"""Observability of a training run, the port of ``gtopkssgd_tpu/obs``'s
anomaly core and its host planes (ROADMAP item 7b):

  counters.py  on-device training-health counters of the compression
               pipeline (achieved density, tau, grad/residual norms, wire
               bytes, mass capture; per layer with the residual age; the
               exact-top-k recall audit), computed inside the optimizer's
               step and read once a dispatch.
  tracing.py   ``Tracer`` spans: host timing and a profiler/NVTX range
               under one name, flushed as "spans" records.
  watchdog.py  ``StallWatchdog``: a monitor thread that exits 43 with a
               "stall" record when a dispatch makes no progress.
  events.py    ``AnomalyMonitor``: rules over the loss and the counters,
               "event" records, ``AnomalyHalt`` (exit 44).
  timeline.py  the host timeline as a Chrome-trace JSON.
  exporter.py  the latest metric values as OpenMetrics text on a
               localhost port.

The planes that read device traces and fleets (trace attribution,
critical path, calibration, link map, memory watch, goodput, fleet,
forecast, registry, report, ledger) are not ported yet (ROADMAP item 7c).
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
