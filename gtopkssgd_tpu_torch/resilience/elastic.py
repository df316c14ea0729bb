"""Elastic fleet: resize the ranks without losing a step, the port of
``gtopkssgd_tpu/resilience/elastic.py``.

The resize protocol (``Trainer._resize_now`` and ``dist_trainer``):

  trigger   an agreed preemption under ``--elastic`` (to P - 1, unless
            that is below ``--min-fleet``), an injected
            ``resize@K:NEWP`` / ``evict_rank:R@K``, or an eviction
            (``eviction_decision`` on the merged fleet view, rank 0's
            self-check every ``--evict-after-windows`` goodput windows)
  drain     acted on only at a dispatch boundary, where the state is whole
  save      every rank's checkpoint at the drained step; the sidecar
            records the world size, the residual's partition width
  lineage   rank 0 rewrites ``elastic.json`` in the out dir (one
            ``lineage_id`` for the logical run, ``resize_epoch`` + 1, the
            new P, the drained step), and a flushed "resize" record lands
  exit 46   ``ResizeRestart`` -> ``EXIT_RESIZE_RESTART``: relaunch with
            ``--resume --elastic --nworkers NEWP``

The one P-shaped state is the error-feedback residual: rank r holds row r
of a [P, N] buffer (each of its layouts: the flat residual, which holds
the per-leaf one in layout order, and ``v``/``u`` under momentum
correction). ``repartition_buffer`` re-splits it: growing appends zero
rows (a new rank starts with an empty residual, as at step 0); shrinking
folds each orphaned row r into survivor r % new_p by addition, which
conserves every column sum (the pending gradient mass) up to float32
rounding. The restoring rank reads only the rows it needs
(``source_rows``), each from its old rank's file.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

LINEAGE_FILE = "elastic.json"


class ResizeRestart(RuntimeError):
    """Raised by the trainer once the resize checkpoint, the lineage file
    and the "resize" record are on disk; the command line maps it to
    ``EXIT_RESIZE_RESTART`` (46)."""


# ------------------------------------------------------------- lineage

def mint_lineage_id() -> str:
    """A fresh lineage id for a logical run (kept across resizes)."""
    return uuid.uuid4().hex[:16]


def lineage_path(out_dir: str) -> str:
    return os.path.join(out_dir, LINEAGE_FILE)


def load_lineage(out_dir: Optional[str]) -> Optional[Dict[str, Any]]:
    """The lineage carried into this run, or None for a fresh start; a
    malformed file reads as None (the run then starts a new lineage)."""
    if not out_dir:
        return None
    try:
        with open(lineage_path(out_dir)) as fh:
            rec = json.load(fh)
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) and rec.get("lineage_id") else None


def write_lineage(out_dir: str, **fields: Any) -> Dict[str, Any]:
    """Write ``elastic.json`` atomically (temporary file, fsync, rename);
    returns the record written."""
    os.makedirs(out_dir, exist_ok=True)
    path = lineage_path(out_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(fields, fh, sort_keys=True)
        fh.write("\n")
        fh.flush()
        try:
            os.fsync(fh.fileno())
        except OSError:
            pass
    os.replace(tmp, path)
    return dict(fields)


# ------------------------------------------------------- repartitioning

def repartition_buffer(buf: np.ndarray, new_p: int) -> np.ndarray:
    """Re-split a per-rank buffer [old_p, ...] onto new_p rows: grow
    copies the rows and appends zero rows; shrink folds orphaned row r
    into row r % new_p by addition, r ascending."""
    buf = np.asarray(buf)
    if buf.ndim < 1:
        raise ValueError("residual buffer must carry a leading [P] dim")
    old_p = buf.shape[0]
    if new_p < 1:
        raise ValueError(f"new_p must be >= 1, got {new_p}")
    if new_p == old_p:
        return buf.copy()
    if new_p > old_p:
        out = np.zeros((new_p,) + buf.shape[1:], dtype=buf.dtype)
        out[:old_p] = buf
        return out
    out = buf[:new_p].copy()
    for r in range(new_p, old_p):
        out[r % new_p] += buf[r]
    return out


def repartition_residual(residual: Any, new_p: int) -> Any:
    """``repartition_buffer`` over each buffer of a residual layout: an
    array, or a dict, list or tuple of them (``{"v", "u"}`` under
    momentum correction)."""
    if isinstance(residual, dict):
        return {key: repartition_residual(v, new_p)
                for key, v in residual.items()}
    if isinstance(residual, (list, tuple)):
        return type(residual)(repartition_residual(v, new_p)
                              for v in residual)
    return repartition_buffer(np.asarray(residual), new_p)


def source_rows(rank: int, old_p: int, new_p: int) -> List[int]:
    """The old rows new rank `rank` holds after ``repartition_buffer``,
    in the order it adds them: its own row if it existed, then rows
    rank + new_p * j (a shrink); none for a rank a grow added."""
    if rank >= old_p:
        return []
    return list(range(rank, old_p, new_p)) if new_p < old_p else [rank]


# ------------------------------------------------------------- eviction

def eviction_decision(merged: Mapping[str, Any], *, p: int,
                      min_fleet: int = 1, margin: float = 0.1
                      ) -> Optional[Dict[str, Any]]:
    """Whether the merged fleet view (``obs.fleet.merge``'s dict) calls
    for evicting a rank: ``obs.goodput.advise`` names the rank whose
    goodput_frac sits furthest below the fleet median, by more than
    `margin`; the straggler rows say whether that rank was also a
    persistent straggler. None for a healthy fleet, one already at
    `min_fleet`, or one rank. Otherwise {rank, new_p, reason: "evict",
    source, goodput_frac, fleet_median_frac, dominant_badput,
    persistent_straggler}."""
    from gtopkssgd_tpu_torch.obs import goodput as _goodput

    if p - 1 < max(1, min_fleet):
        return None
    by_rank = merged.get("goodput_by_rank") or {}
    hint = _goodput.advise(by_rank, margin=margin)
    if hint is None:
        return None
    rank = int(hint["rank"])
    persistent = any(
        row.get("slowest_rank") == rank and row.get("persistent")
        for row in merged.get("stragglers") or [])
    return {
        "rank": rank,
        "new_p": p - 1,
        "reason": "evict",
        "source": "goodput_advise",
        "goodput_frac": hint.get("goodput_frac"),
        "fleet_median_frac": hint.get("fleet_median_frac"),
        "dominant_badput": hint.get("dominant_badput"),
        "persistent_straggler": bool(persistent),
    }


def surviving_ranks(old_p: int, evicted: Sequence[int]) -> list:
    """The ranks that re-form the fleet after evicting `evicted`; the
    relaunch numbers them densely in this order."""
    gone = set(int(r) for r in evicted)
    return [r for r in range(old_p) if r not in gone]
