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
emergency save and the run's summary, ``resize`` an elastic resize.
An unregistered kind raises, so a typo fails loudly.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, Optional

KINDS = frozenset({
    "manifest",  # run provenance header (utils/manifest.py), first record
    "plan",      # the wire plan's decision (parallel/planner.py)
    "bucket",    # the layer-wise bucket partition (parallel/bucketing.py)
    "train",     # training stats every log_interval steps
    "eval",      # validation metrics
    "epoch",     # end-of-epoch combined stats
    "inject",    # a fault injection firing (resilience/inject.py)
    "recovery",  # an emergency save, a run's resilience summary
    "resize",    # an elastic resize, before exit 46 (resilience/elastic.py)
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
    an ``out_dir`` nothing is written. A context manager; owners that
    hold one for their whole life call ``close()``."""

    def __init__(self, out_dir: Optional[str] = None, rank: int = 0,
                 shard: bool = False):
        self.rank = rank
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
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
