"""Per-layer metric readers, one module a metric, found by the metric's
name in ``BENCHMARK.json``. Each ``read(ctx)`` returns the metric's value
from the traced stretch (``ctx.trace``, ``portbench.trace.summarize``)
and the run's counters, or None where it finds nothing to read."""
