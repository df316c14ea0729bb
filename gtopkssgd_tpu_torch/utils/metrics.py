"""Structured metrics, the port of ``gtopkssgd_tpu/utils/metrics.py``.

Every record is one JSON line, ``{"kind", "time", "rank", **fields}``,
appended to ``metrics.jsonl`` (one process) or to the rank's own
``metrics.rank{r}.jsonl`` (``shard=True``: every rank of a P-rank run
writes its shard, the names ``shard_filename`` gives) in the out dir.
The file is line-buffered, so a run killed mid-step loses at most the
line being written; ``flush=True`` also fsyncs the record (the manifest).

The port writes the record kinds in ``KINDS``: the run manifest first
(``utils.manifest``), then the wire plan and the buckets where the
trainer has them, ``train`` every ``log_interval`` steps, ``eval`` after
each ``Trainer.test()`` and ``epoch`` after each epoch of ``fit()``;
with the resilience flags, ``inject`` a fault's firing, ``recovery`` an
emergency save, a recovery action and the run's summary, ``resize`` an
elastic resize; with the observability (``obs/``), ``obs`` the counters
and ``layers`` one a layer every ``obs_interval`` steps, ``spans`` the
Tracer's window means, ``event`` an anomaly and ``stall`` the watchdog's
diagnostic, ``goodput`` the goodput ledger's decomposition (on by
default: every ``obs_goodput_interval`` steps and at the end); with the
trace planes, ``attr``, ``critpath`` and ``ledger`` a captured dispatch,
``calib`` and ``linkmap`` the comm model's refits and links, ``forecast``
the scale-out forecast (fsynced), ``compile`` and ``mem`` the compile
and memory watch; ``fleet`` a merged cross-rank row (``obs.fleet``). An
unregistered kind raises, so a typo fails loudly.
``sink`` is called with every record, file or no file (the exporter's
``observe``); its errors are swallowed, so export cannot stop a run.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable, Dict, Optional

KINDS = frozenset({
    "manifest",  # run provenance header (utils/manifest.py), first record
    "plan",      # the wire plan's decision (parallel/planner.py)
    "bucket",    # the layer-wise bucket partition (parallel/bucketing.py)
    "train",     # training stats every log_interval steps
    "eval",      # validation metrics
    "epoch",     # end-of-epoch combined stats
    "inject",    # a fault injection firing (resilience/inject.py)
    "recovery",  # an emergency save, a recovery action (resilience/
                 # policy.py), a run's resilience summary
    "resize",    # an elastic resize, before exit 46 (resilience/elastic.py)
    "obs",       # on-device counters (obs/counters.py)
    "layers",    # per-layer counters, one record a layer an obs step
    "spans",     # Tracer window means (obs/tracing.py flush)
    "event",     # an anomaly event (obs/events.py)
    "stall",     # the stall watchdog's diagnostic (obs/watchdog.py)
    "attr",      # a captured dispatch's T_compute/T_select/T_comm split
                 # (obs/trace_attr.py)
    "critpath",  # its ordered stage segments, comm split into wire and
                 # wait (obs/critpath.py)
    "ledger",    # its measured comm against the alpha-beta model, P > 1
                 # (obs/ledger.py)
    "calib",     # a live refit of the comm model (obs/calib.py)
    "linkmap",   # the per-(class, peer) link weather map (obs/linkmap.py)
    "compile",   # a new batch shape's first step, or a recompile
                 # (obs/memwatch.py)
    "mem",       # a live-memory window (obs/memwatch.py)
    "goodput",   # the cumulative goodput/badput decomposition
                 # (obs/goodput.py)
    "fleet",     # a cross-rank merged row (obs/fleet.py row_record)
    "forecast",  # the hindcast error and the per-P forecast of a capture
                 # (obs/forecast.py); fsynced, before forecast_drift can
                 # halt the run
})

_SHARD_RE = re.compile(r"^metrics\.rank(\d+)\.jsonl$")


def shard_filename(rank: int) -> str:
    """The per-rank shard's name."""
    return f"metrics.rank{rank}.jsonl"


def shard_rank(path: str) -> Optional[int]:
    """The rank a shard's file name holds, or None for other names."""
    m = _SHARD_RE.match(os.path.basename(path))
    return int(m.group(1)) if m else None


class MetricsLogger:
    """``shard=True`` (P > 1) writes ``metrics.rank{rank}.jsonl`` on every
    rank; the default writes ``metrics.jsonl`` on rank 0 only. Without
    an ``out_dir`` nothing is written. ``sink(record)`` sees every
    record. A context manager; owners that
    hold one for their whole life call ``close()``."""

    def __init__(self, out_dir: Optional[str] = None, rank: int = 0,
                 shard: bool = False,
                 sink: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.rank = rank
        self.sink = sink
        self._fh = None
        if out_dir is not None and (shard or rank == 0):
            os.makedirs(out_dir, exist_ok=True)
            name = shard_filename(rank) if shard else "metrics.jsonl"
            self._fh = open(os.path.join(out_dir, name), "a", buffering=1)

    def log(self, kind: str, *, flush: bool = False,
            **fields: Any) -> Dict[str, Any]:
        """Append one record; ``flush=True`` fsyncs it before returning.
        After ``close()`` records are returned and written nowhere."""
        if not isinstance(kind, str) or not kind:
            raise ValueError(
                f"metrics kind must be a non-empty str, got {kind!r}")
        if kind not in KINDS:
            raise ValueError(
                f"unregistered metrics kind {kind!r}; add it to "
                f"utils.metrics.KINDS (registered: {sorted(KINDS)})")
        rec = {"kind": kind, "time": time.time(), "rank": self.rank, **fields}
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            if flush:
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                except OSError:
                    pass
        if self.sink is not None:
            try:
                self.sink(rec)
            except Exception:
                pass
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
