"""The run registry, the port of ``gtopkssgd_tpu/obs/registry.py``: an
append-only memory of the runs of a workspace.

One run's records say what happened in that run; nothing else remembers
the run before it. With ``--registry DIR`` the trainer's rank 0 appends
ONE line to ``DIR/runs.jsonl`` as it exits (every exit: 0, 44, 45, 46):
the manifest's identity fields and the run's summary statistics
(``run_summary``). The report reads it back offline:

    python -m gtopkssgd_tpu_torch.obs.report history REGISTRY_DIR
    python -m gtopkssgd_tpu_torch.obs.report regress RUN --registry DIR

``history`` prints the trend table (comparable runs share a
``config_hash``); ``regress`` summarizes RUN from its shards, takes the
newest entry of the same ``config_hash`` (or of the same elastic lineage)
as the baseline and checks each ``REGRESS_CHECKS`` field within its
tolerance, with ``report gate``'s exit codes: 0 within tolerance, 1 a
regression, 2 a usage error or no baseline. A statistic the run did not
produce is absent from its line, never written as 0. Lines are plain
JSON: a torn line is counted and skipped, and registries merge with
``cat``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

REGISTRY_NAME = "runs.jsonl"

# Manifest keys copied into each entry: config_hash keys comparability,
# the rest make a registry line readable without the run directory.
# lineage_id/resize_epoch (elastic runs only — resilience/elastic.py)
# join the pre/post segments of a resized run into ONE trajectory even
# though the config_hash changes with --nworkers.
_MANIFEST_KEYS = ("config_hash", "git_sha", "dnn", "dataset",
                  "compression", "density", "wire_codec", "nworkers",
                  "batch_size", "seed", "lineage_id", "resize_epoch")

# Regression checks: (field, rtol, atol). Gate tolerance semantics —
# FAIL when |current - baseline| > atol + rtol*|baseline|. Throughput
# and loss are noisy (25%); comm ratio noisier still; fitted alpha/beta
# tolerate a full 2x before flagging (factor-level drift is what the
# live comm_model_drift rule exists for — the registry catches the
# slow cross-run creep); wire bytes/step is deterministic (10% covers
# codec padding jitter only); recall floor gets an absolute slack so a
# floor of 0.0 doesn't make the check vacuous. The two memwatch fields
# (--obs-mem runs only) are the space plane: peak_hbm_bytes is the CUDA
# caching allocator's peak over the first step of each dispatch shape,
# which moves only when the program does (10% covers the allocator's
# rounding and the libraries' workspaces), and recompile_count is exact
# — ANY cross-run change in how often the run made a new executable
# under the same config is a regression. overlap_frac (the
# measured fraction of comm hidden under compute/select, trace-derived)
# gets a purely absolute 0.1 slack: it lives in [0, 1] and a serial
# baseline of 0.0 must still bound an overlapped current run — a
# pipelined run whose overlap silently collapsed back to serial is
# exactly the regression this line exists to catch. n_buckets is exact:
# the DP re-deciding B under the same config means the cost model moved.
REGRESS_CHECKS: Tuple[Tuple[str, float, float], ...] = (
    ("steps_per_sec", 0.25, 0.0),
    ("loss_last", 0.25, 0.0),
    ("mean_comm_ratio", 0.50, 0.0),
    ("alpha_ms", 1.00, 0.0),
    ("beta_gbps", 1.00, 0.0),
    ("recall_floor", 0.25, 0.05),
    ("wire_bytes_per_step", 0.10, 0.0),
    ("peak_hbm_bytes", 0.10, 0.0),
    ("recompile_count", 0.0, 0.0),
    ("overlap_frac", 0.0, 0.10),
    ("n_buckets", 0.0, 0.0),
    # wait_frac (mean share of each rank's step wall spent blocked at
    # collectives, from the critpath plane) gets the same purely
    # absolute 0.1 slack as overlap_frac and for the same reason: it
    # lives in [0, 1] and a clean baseline of 0.0 must still bound a
    # current run that started skewing.
    ("wait_frac", 0.0, 0.10),
    # goodput_frac (productive share of the run's wall, from the
    # goodput ledger's final summary — obs/goodput.py) is the single
    # number the whole badput taxonomy rolls up to; purely absolute
    # 0.1 slack for the same [0, 1] reason as the two above — a run
    # whose productive share quietly dropped ten points under the same
    # config is the regression this line pins.
    ("goodput_frac", 0.0, 0.10),
    # hindcast_err_x (forecast plane, obs/forecast.py: predicted vs
    # measured step time on the run itself) lives near 1.0 by
    # construction; a purely absolute 0.5 slack pins it — a model whose
    # self-explanation quietly worsened past half a turn under the same
    # config is a forecast regression, the offline mirror of the live
    # forecast_drift rule.
    ("hindcast_err_x", 0.0, 0.50),
)

# String-valued stats checked for EXACT equality (the numeric loop's
# finiteness gate would silently skip them — a chosen pipeline that
# flips serial<->overlap under the same config is a plan regression,
# not noise; the modal critical stage moving compute<->wait under the
# same config means the run's bottleneck moved, which is exactly what
# the critpath plane exists to flag). The forecast plane's per-target
# recommendations (forecast_rec_p256 etc.) join this set dynamically in
# regress(): a silent flip of the recommended P=256 plan under the same
# config must fail the gate.
REGRESS_EXACT_STR: Tuple[str, ...] = ("pipeline", "crit_stage_modal")


def _finite(x: Any) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def registry_path(registry_dir: str) -> str:
    return os.path.join(registry_dir, REGISTRY_NAME)


def _cell(v: Any) -> str:
    """Table cell: report._fmt for numbers, "-" for absent stats."""
    if _finite(v):
        from gtopkssgd_tpu_torch.obs.report import _fmt
        return _fmt(float(v))
    return "-" if v is None else str(v)


def run_summary(records: Sequence[Dict[str, Any]]
                ) -> Optional[Dict[str, Any]]:
    """Distill one run's record stream into a registry entry: manifest
    subset + summary stats. Stats a run didn't produce (no calib
    records, no audits) are simply absent — ``regress`` treats a field
    missing on both sides as not-applicable, present-then-vanished as a
    failure. Returns None when the stream has no manifest (nothing to
    key comparisons on)."""
    manifest = None
    trains: List[Dict[str, Any]] = []
    last_calib = None
    last_plan = None
    final_status = None
    recall_floor = None
    wire_sum, wire_n = 0.0, 0
    ratio_sum, ratio_n = 0.0, 0
    ofrac_sum, ofrac_n = 0.0, 0
    wait_sum, wait_n = 0.0, 0
    crit_counts: Dict[str, int] = {}
    saw_memwatch = False
    recompile_count = 0
    peak_hbm: Optional[int] = None
    last_goodput = None
    last_forecast = None
    for rec in records:
        kind = rec.get("kind")
        if kind == "manifest" and manifest is None:
            manifest = rec
        elif kind == "train":
            trains.append(rec)
        elif kind == "calib":
            last_calib = rec
        elif kind == "plan":
            last_plan = rec
        elif kind in ("compile", "mem"):
            # memwatch (--obs-mem) was on; recompile_count stays an
            # explicit 0 in that case so regress can pin it exactly.
            saw_memwatch = True
            if _finite(rec.get("recompile_count")):
                recompile_count = max(recompile_count,
                                      int(rec["recompile_count"]))
            # The port's card peak rides the "compile" records (the
            # allocator's over each shape's first step): the largest.
            if kind == "compile" and _finite(rec.get("peak_hbm_bytes")):
                peak_hbm = (int(rec["peak_hbm_bytes"]) if peak_hbm is None
                            else max(peak_hbm, int(rec["peak_hbm_bytes"])))
        elif kind == "obs":
            recall = rec.get("audit_recall")
            if _finite(recall) and recall >= 0:
                recall_floor = (recall if recall_floor is None
                                else min(recall_floor, recall))
            wb = rec.get("wire_bytes")
            if _finite(wb) and wb > 0:
                wire_sum += float(wb)
                wire_n += 1
        elif kind == "attr":
            # measured comm share of the dispatch — the ledger's
            # numerator; ratio vs total is schedule-independent
            tc, tt = rec.get("t_comm_us"), rec.get("t_total_us")
            if _finite(tc) and _finite(tt) and tt > 0:
                ratio_sum += float(tc) / float(tt)
                ratio_n += 1
            if _finite(rec.get("overlap_frac")):
                ofrac_sum += float(rec["overlap_frac"])
                ofrac_n += 1
        elif kind == "critpath":
            # per-rank stage-interval plane (obs/critpath.py): the mean
            # blocked share and the modal LOCAL critical stage across
            # all shipped records — cross-run comparable without the
            # fleet join.
            if _finite(rec.get("wait_frac")):
                wait_sum += float(rec["wait_frac"])
                wait_n += 1
            cs = rec.get("crit_stage")
            if isinstance(cs, str) and cs:
                crit_counts[cs] = crit_counts.get(cs, 0) + 1
        elif kind == "goodput":
            # cumulative ledger records (obs/goodput.py): the LAST one
            # is the run's accounting, so it alone feeds the entry.
            last_goodput = rec
        elif kind == "forecast":
            # scale-out forecast records (obs/forecast.py): the LAST
            # one carries the settled hindcast error and per-P
            # recommendations, so it alone feeds the entry.
            last_forecast = rec
        elif kind == "recovery" and rec.get("final_status") is not None:
            final_status = rec.get("final_status")
    if manifest is None:
        return None
    entry: Dict[str, Any] = {"time": manifest.get("time")}
    for key in _MANIFEST_KEYS:
        if manifest.get(key) is not None:
            entry[key] = manifest[key]
    stats: Dict[str, Any] = {}
    steps = [r for r in trains
             if _finite(r.get("step")) and _finite(r.get("time"))]
    if len(steps) >= 2:
        dt = steps[-1]["time"] - steps[0]["time"]
        ds = steps[-1]["step"] - steps[0]["step"]
        if dt > 0 and ds > 0:
            stats["steps_per_sec"] = round(ds / dt, 6)
    if trains:
        stats["n_steps"] = trains[-1].get("step")
        loss = trains[-1].get("loss")
        if _finite(loss):
            stats["loss_last"] = round(float(loss), 6)
    if ratio_n:
        stats["mean_comm_ratio"] = round(ratio_sum / ratio_n, 6)
    if last_calib is not None:
        if _finite(last_calib.get("alpha_fit_ms")):
            stats["alpha_ms"] = last_calib["alpha_fit_ms"]
        if _finite(last_calib.get("beta_fit_gbps")):
            stats["beta_gbps"] = last_calib["beta_fit_gbps"]
        # Per-axis fits ride the calib record under dotted keys
        # (alpha_ms.dcn, beta_gbps.ici, ...); carry them verbatim so
        # regress can pin each measured hop, not just the blend.
        for field in sorted(last_calib):
            if ((field.startswith("alpha_ms.")
                 or field.startswith("beta_gbps."))
                    and _finite(last_calib[field])):
                stats[field] = last_calib[field]
    if recall_floor is not None:
        stats["recall_floor"] = round(float(recall_floor), 6)
    if wire_n:
        stats["wire_bytes_per_step"] = round(wire_sum / wire_n, 2)
    # A manifest that carries the peak (another writer's) wins, as in
    # the JAX registry; the port's manifest is written before any step.
    if _finite(manifest.get("peak_hbm_bytes")):
        stats["peak_hbm_bytes"] = manifest["peak_hbm_bytes"]
    elif peak_hbm is not None:
        stats["peak_hbm_bytes"] = peak_hbm
    if saw_memwatch:
        stats["recompile_count"] = recompile_count
    if ofrac_n:
        stats["overlap_frac"] = round(ofrac_sum / ofrac_n, 6)
    if wait_n:
        stats["wait_frac"] = round(wait_sum / wait_n, 6)
    if last_goodput is not None:
        if _finite(last_goodput.get("goodput_frac")):
            stats["goodput_frac"] = round(
                float(last_goodput["goodput_frac"]), 6)
        if _finite(last_goodput.get("other_frac")):
            stats["other_frac"] = round(
                float(last_goodput["other_frac"]), 6)
    if last_forecast is not None:
        # Forecast plane: the hindcast error (numeric drift check) plus
        # the recommended plan string at each P target
        # (forecast_rec_p{P}, exact-string checked in regress() — a
        # calibrated artifact flipping the P=256 recommendation is a
        # DELIBERATE change that must fail a same-config gate).
        if _finite(last_forecast.get("hindcast_err_x")):
            stats["hindcast_err_x"] = round(
                float(last_forecast["hindcast_err_x"]), 6)
        if _finite(last_forecast.get("crossover_p")):
            stats["forecast_crossover_p"] = int(
                last_forecast["crossover_p"])
        for field in sorted(last_forecast):
            if (field.startswith("rec_p") and field[5:].isdigit()
                    and isinstance(last_forecast[field], str)):
                stats["forecast_" + field] = last_forecast[field]
    if crit_counts:
        # Modal stage; ties break by critpath.STAGES order (inlined as
        # a sort over the fixed tuple to keep the registry stdlib-only).
        order = ("compute", "select", "comm", "wait")
        stats["crit_stage_modal"] = max(
            sorted(crit_counts, key=lambda s: order.index(s)
                   if s in order else len(order)),
            key=lambda s: crit_counts[s])
    # Plan-shape stats: the chosen pipeline (plan record wins — it is
    # the decision as executed; the manifest stamp is the fallback for
    # runs without a planner) and the DP's bucket count, so regress can
    # pin both exactly across runs of the same config.
    pipeline = (last_plan or {}).get("pipeline") or manifest.get("pipeline")
    if pipeline is not None:
        stats["pipeline"] = str(pipeline)
    bucket_ks = manifest.get("bucket_ks")
    if isinstance(bucket_ks, (list, tuple)) and bucket_ks:
        stats["n_buckets"] = len(bucket_ks)
    if final_status is not None:
        stats["final_status"] = final_status
    entry["stats"] = stats
    return entry


def append_run(registry_dir: str, entry: Dict[str, Any]) -> str:
    """Append one entry (fsync'd — a registry line is the run's only
    cross-run trace, it must survive the process dying right after)."""
    os.makedirs(registry_dir, exist_ok=True)
    path = registry_path(registry_dir)
    with open(path, "a") as fh:
        fh.write(json.dumps(entry, sort_keys=True) + "\n")
        fh.flush()
        try:
            os.fsync(fh.fileno())
        except OSError:
            pass
    return path


def load_registry(registry_dir: str) -> Tuple[List[Dict[str, Any]], int]:
    """All parseable entries in file order, plus the count of bad lines
    (a torn write from a killed run must not poison the registry)."""
    path = registry_path(registry_dir)
    entries: List[Dict[str, Any]] = []
    bad = 0
    if not os.path.exists(path):
        return entries, bad
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                bad += 1
                continue
            if isinstance(rec, dict):
                entries.append(rec)
            else:
                bad += 1
    return entries, bad


def history_rows(entries: Sequence[Dict[str, Any]],
                 config_hash: Optional[str] = None
                 ) -> List[List[str]]:
    """Trend-table rows (newest last) for ``report history``; filtered
    to one config_hash when given. The filter follows elastic lineage:
    an entry whose lineage_id matches any hash-matched entry's is kept
    too, so a resized run's pre/post segments (different --nworkers,
    hence different config_hash) render as one trajectory."""
    lineages = {e.get("lineage_id") for e in entries
                if config_hash and e.get("config_hash") == config_hash
                and e.get("lineage_id")}
    rows = []
    for e in entries:
        if config_hash and e.get("config_hash") != config_hash and not (
                e.get("lineage_id") and e.get("lineage_id") in lineages):
            continue
        stats = e.get("stats") or {}
        # Compact per-axis fit cell: "dcn:0.73/4.9 ici:0/4.9" —
        # alpha_ms/beta_gbps per measured axis; "-" pre-linkmap.
        ax_names = sorted({f.split(".", 1)[1] for f in stats
                           if f.startswith(("alpha_ms.", "beta_gbps."))})
        axes_cell = " ".join(
            f"{a}:{_cell(stats.get('alpha_ms.' + a))}"
            f"/{_cell(stats.get('beta_gbps.' + a))}"
            for a in ax_names) or "-"
        rows.append([
            str(e.get("config_hash", "?"))[:16],
            str(e.get("git_sha", "?"))[:10],
            _cell(stats.get("n_steps")),
            _cell(stats.get("steps_per_sec")),
            _cell(stats.get("loss_last")),
            _cell(stats.get("mean_comm_ratio")),
            _cell(stats.get("alpha_ms")),
            _cell(stats.get("beta_gbps")),
            axes_cell,
            _cell(stats.get("recall_floor")),
            _cell(stats.get("wire_bytes_per_step")),
            _cell(stats.get("peak_hbm_bytes")),
            _cell(stats.get("recompile_count")),
            str(stats.get("pipeline", "-")),
            _cell(stats.get("n_buckets")),
            _cell(stats.get("overlap_frac")),
            str(stats.get("crit_stage_modal", "-")),
            _cell(stats.get("wait_frac")),
            _cell(stats.get("goodput_frac")),
            _cell(stats.get("hindcast_err_x")),
            str(stats.get("forecast_rec_p256", "-")),
            # "lid8:epoch" for elastic runs — the join key that groups
            # a resized run's segments; "-" for classic runs.
            (f"{str(e['lineage_id'])[:8]}:{e.get('resize_epoch', 0)}"
             if e.get("lineage_id") else "-"),
            str(stats.get("final_status", "-")),
        ])
    return rows


HISTORY_HEADER = ["config", "git", "steps", "steps/s", "loss",
                  "comm_ratio", "alpha_ms", "beta_gbps", "axes",
                  "recall", "wireB/step", "peak_hbm", "recomp",
                  "pipeline", "B", "ovl_frac", "crit_stage",
                  "wait_frac", "goodput", "hindcast", "fc_p256",
                  "lineage", "status"]


def pick_baseline(entry: Dict[str, Any],
                  entries: Sequence[Dict[str, Any]],
                  allow_mismatch: bool = False
                  ) -> Optional[Dict[str, Any]]:
    """Most recent registry entry with the current run's config_hash
    (comparing runs of different configurations is apples-to-oranges —
    opt in explicitly with allow_mismatch). Elastic exception: an entry
    sharing the run's lineage_id is the SAME logical run on a different
    fleet size, so it baselines a post-resize segment without
    allow_mismatch — size-dependent fields (wire bytes, fits) drift and
    should be read with that in mind, but loss/recall continuity is
    exactly what the lineage join exists to check."""
    want = entry.get("config_hash")
    matches = [e for e in entries
               if want is not None and e.get("config_hash") == want]
    if matches:
        return matches[-1]
    lid = entry.get("lineage_id")
    kin = [e for e in entries
           if lid is not None and e.get("lineage_id") == lid]
    if kin:
        return kin[-1]
    if allow_mismatch and entries:
        return entries[-1]
    return None


def regress(entry: Dict[str, Any], baseline: Dict[str, Any]
            ) -> Tuple[List[List[str]], int]:
    """Field-by-field drift check of ``entry`` against ``baseline``
    under REGRESS_CHECKS. Returns (table rows, failure count). A field
    absent from both runs is skipped; absent from the baseline only is
    noted "new" (new instrumentation is not a regression); present in
    the baseline but vanished from the current run FAILS — a counter
    that silently disappears is exactly the kind of regression the
    registry exists to catch."""
    cur = entry.get("stats") or {}
    base = baseline.get("stats") or {}
    rows: List[List[str]] = []
    failures = 0
    # Per-axis alpha/beta stats (alpha_ms.<axis> / beta_gbps.<axis>,
    # from the calibrator's per-axis fits) are dynamic — the axis names
    # are the link classes', not ours — so pin every one present on either
    # side at the same 2x rtol the blended fit gets: a silently
    # degraded hop fails the cross-run gate like any other field.
    axis_checks = tuple(
        (field, 1.00, 0.0)
        for field in sorted(set(cur) | set(base))
        if field.startswith(("alpha_ms.", "beta_gbps.")))
    for field, rtol, atol in REGRESS_CHECKS + axis_checks:
        have_cur, have_base = _finite(cur.get(field)), _finite(
            base.get(field))
        if not have_cur and not have_base:
            continue
        tol_s, status = "-", "ok"
        if not have_base:
            status = "new"
        elif not have_cur:
            status = "MISSING"
            failures += 1
        else:
            b, c = float(base[field]), float(cur[field])
            tol = atol + rtol * abs(b)
            tol_s = _cell(tol)
            if abs(c - b) > tol:
                status = "FAIL"
                failures += 1
        rows.append([field, _cell(base.get(field)), _cell(cur.get(field)),
                     tol_s, status])
    # Forecast recommendations are dynamic like the per-axis fits (one
    # per configured P target), so every forecast_rec_p* present on
    # either side joins the exact-string set: the recommended plan
    # flipping under the same config — a calibrated artifact repricing
    # the grid — must fail the gate, never slide through silently.
    forecast_checks = tuple(
        field for field in sorted(set(cur) | set(base))
        if field.startswith("forecast_rec_p"))
    for field in REGRESS_EXACT_STR + forecast_checks:
        b, c = base.get(field), cur.get(field)
        if b is None and c is None:
            continue
        if b is None:
            status = "new"
        elif c is None:
            status = "MISSING"
            failures += 1
        elif str(c) != str(b):
            status = "FAIL"
            failures += 1
        else:
            status = "ok"
        rows.append([field, "-" if b is None else str(b),
                     "-" if c is None else str(c), "exact", status])
    return rows, failures


REGRESS_HEADER = ["field", "baseline", "current", "tol", "status"]
