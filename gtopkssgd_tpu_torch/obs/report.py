"""The metrics report, the port of ``gtopkssgd_tpu/obs/report.py``: one
run's records summarized, two runs compared, a run gated against a
baseline, and a view of each plane, offline, over the record files the
trainer writes. Its grammar and exit codes are the JAX CLI's:

    python -m gtopkssgd_tpu_torch.obs.report RUN [RUN_B] [--kinds K,..]
        [--json OUT]                  summary of one run; two: mean vs mean
    ... gate RUN --baseline B [--write OUT]
                                      checks against a baseline JSON
    ... attr RUN|TRACE                T_compute / T_select / T_comm ("attr"
                                      records, or a torch.profiler trace)
    ... events RUN                    anomaly events by rule
    ... recovery RUN                  injected faults and recovery actions
    ... timeline RUN [--out PATH]     the Chrome-trace timeline, rebuilt
    ... fleet RUN.. [--kinds K,..]    the ranks' shards merged: per-step
                                      cross-rank stats, the stragglers
    ... critpath RUN.. [--halt-on S]  the global per-step critical path
    ... goodput RUN.. [--advise] [--compare OTHER]
                                      goodput/badput by rank and the fleet
    ... watch RUN.. [--iterations N]  a live tail of the shards
    ... plan RUN                      the wire plan's decision, the buckets
    ... compile RUN                   the compile records, the recompiles
    ... mem RUN                       the live-memory windows
    ... ledger RUN..                  measured comm against the model
    ... linkmap RUN..                 the per-(link class, peer) weather map
    ... forecast RUN..                hindcast error, the per-P forecast
    ... history REGISTRY              the run registry's trend table
    ... regress RUN --registry R      the run against its registry baseline

A RUN is an out dir (``metrics.jsonl``, or the ranks' ``metrics.rank{r}
.jsonl`` shards, which load as their concatenation in rank order) or a
record file. Exit codes: 0 pass, 1 a regression or nothing to show, 2 a
usage error (an unreadable run, a baseline that is not there).

What differs from the JAX CLI is what the port's records hold: ``attr``
parses a ``torch.profiler`` trace (``obs.trace_attr``); ``compile`` and
``mem`` print the memory watch's records (``obs.memwatch``: the CUDA
caching allocator and ``FlopCounterMode``, not XLA's cost analysis), so
the fields XLA gives and the allocator does not (bytes accessed, temp,
argument and output bytes, lowering time) are left out; ``ledger`` and
``forecast`` price with the card's fits (``obs.ledger.load_alpha_beta``:
a ``calib_fit_{P}proc.json`` in ``--probe-dir``, else the fit committed
for the run's backend) and print nothing where there is no fit.

Malformed lines are counted and skipped, never fatal: a run killed by the
stall watchdog may leave a torn last line.
"""

from __future__ import annotations

import argparse
import json
import os
import time as _time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from gtopkssgd_tpu_torch.utils.metrics import KINDS, shard_rank

# Bookkeeping fields that are not measurements; excluded from aggregation.
_META_FIELDS = {"kind", "time", "rank"}


def resolve_path(run: str) -> str:
    """<run dir> -> its metrics.jsonl; a file path passes through. When
    the dir has only rank shards, rank 0's shard is the representative
    single path (use resolve_paths for the whole fleet)."""
    if os.path.isdir(run):
        single = os.path.join(run, "metrics.jsonl")
        if os.path.exists(single):
            return single
        shards = _shard_paths(run)
        if shards:
            return shards[0]
        return single
    return run


def _shard_paths(run_dir: str) -> List[str]:
    """metrics.rank{r}.jsonl shards in a dir, sorted by rank."""
    found = []
    for name in os.listdir(run_dir):
        r = shard_rank(name)
        if r is not None:
            found.append((r, os.path.join(run_dir, name)))
    return [path for _, path in sorted(found)]


def resolve_paths(run: str) -> List[str]:
    """Every record file a run target names: [metrics.jsonl] for classic
    runs, all rank shards (rank order) for sharded dirs, the file itself
    for file paths."""
    if os.path.isdir(run):
        single = os.path.join(run, "metrics.jsonl")
        if os.path.exists(single):
            return [single]
        shards = _shard_paths(run)
        return shards if shards else [single]
    return [run]


def _parse_lines(lines: Iterable[str]) -> Tuple[List[dict], int]:
    records, bad = [], 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            bad += 1
            continue
        if isinstance(rec, dict):
            records.append(rec)
        else:
            bad += 1
    return records, bad


def load_records(run: str) -> Tuple[List[dict], int]:
    """Parse a run's records — concatenating rank shards (rank order)
    when the target is a sharded dir, so aggregate means over a fleet
    dir ARE the fleet-merged means. Returns (records, n_malformed)."""
    records, bad = [], 0
    for path in resolve_paths(run):
        with open(path) as fh:
            recs, b = _parse_lines(fh)
        records.extend(recs)
        bad += b
    return records, bad


def unregistered_kinds(records: Iterable[dict]) -> List[str]:
    """Kinds present in a record stream but missing from the writer's
    registry (utils.metrics.KINDS) — a hand-edited file or a
    version-skewed writer; flagged, never fatal."""
    return sorted({str(rec.get("kind")) for rec in records
                   if rec.get("kind") not in KINDS})


def summarize(records: Iterable[dict]) -> Dict[str, Dict[str, dict]]:
    """{kind: {field: {count, mean, min, max, last}}} over numeric fields."""
    acc: Dict[str, Dict[str, List[float]]] = {}
    for rec in records:
        kind = str(rec.get("kind", "?"))
        if kind == "manifest":
            continue  # provenance header, not a measurement stream
        fields = acc.setdefault(kind, {})
        for key, val in rec.items():
            if key in _META_FIELDS:
                continue
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            fields.setdefault(key, []).append(float(val))
    out: Dict[str, Dict[str, dict]] = {}
    for kind, fields in acc.items():
        out[kind] = {}
        for key, vals in fields.items():
            out[kind][key] = {
                "count": len(vals),
                "mean": sum(vals) / len(vals),
                "min": min(vals),
                "max": max(vals),
                "last": vals[-1],
            }
    return out


def extract_manifest(records: Iterable[dict]) -> Optional[dict]:
    """The run's manifest record (kind "manifest"), or None. First wins:
    the trainer writes it before any measurement record."""
    for rec in records:
        if rec.get("kind") == "manifest":
            return rec
    return None


def summarize_layers(records: Iterable[dict]) -> Dict[str, Dict[str, dict]]:
    """{layer: {field: {count, mean, min, max, last}}} over the numeric
    fields of kind=="layers" records (the per-layer telemetry stream)."""
    by_layer: Dict[str, List[dict]] = {}
    for rec in records:
        if rec.get("kind") != "layers":
            continue
        by_layer.setdefault(str(rec.get("layer", "?")), []).append(rec)
    return {
        layer: summarize(recs).get("layers", {})
        for layer, recs in by_layer.items()
    }


def format_manifest(man: dict) -> str:
    rows = [
        [key, json.dumps(val) if isinstance(val, dict) else str(val)]
        for key, val in man.items()
        if key not in _META_FIELDS
    ]
    return "[manifest]\n" + _table(rows, ["key", "value"])


# Per-layer table column order; "layer" (the row key) and "step" are
# implicit. Mirrors counters.LAYER_FIELDS without importing torch here.
_LAYER_COLUMNS = ("density", "tau", "m_k", "residual_age", "residual_norm",
                  "grad_norm_pre", "grad_norm_post")


def format_layers(by_layer: Dict[str, Dict[str, dict]]) -> str:
    """One row per layer, mean of each per-layer counter over the run."""
    cols = [c for c in _LAYER_COLUMNS
            if any(c in fields for fields in by_layer.values())]
    rows = []
    for layer in sorted(by_layer):
        fields = by_layer[layer]
        rows.append([layer] + [
            _fmt(fields[c]["mean"]) if c in fields else "-" for c in cols
        ])
    n = max((max(s["count"] for s in f.values()) if f else 0)
            for f in by_layer.values())
    return (f"[layers] ({len(by_layer)} layers x {n} obs steps; "
            "mean per layer)\n"
            + _table(rows, ["layer"] + [f"mean({c})" for c in cols]))


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "nan"
    a = abs(v)
    if (a != 0 and a < 1e-3) or a >= 1e7:
        return f"{v:.4g}"
    if a >= 100 or v == int(v):
        return f"{v:.6g}"
    return f"{v:.4f}"


def _opt(v: Optional[float]) -> str:
    """_fmt of a field a record may leave out: "-" where it did."""
    return "-" if v is None else _fmt(v)


def _table(rows: List[Sequence[str]], header: Sequence[str]) -> str:
    widths = [
        max(len(str(r[i])) for r in [header] + rows)
        for i in range(len(header))
    ]
    lines = []
    for r in [header, ["-" * w for w in widths]] + rows:
        lines.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)


def format_summary(name: str, summary: Dict[str, Dict[str, dict]],
                   kinds: Optional[Sequence[str]] = None) -> str:
    chunks = [f"run: {name}"]
    for kind in sorted(summary):
        if kinds and kind not in kinds:
            continue
        fields = summary[kind]
        if not fields:
            continue
        n = max(s["count"] for s in fields.values())
        chunks.append(f"\n[{kind}] ({n} records)")
        rows = [
            [key, str(s["count"]), _fmt(s["mean"]), _fmt(s["min"]),
             _fmt(s["max"]), _fmt(s["last"])]
            for key, s in sorted(fields.items())
        ]
        chunks.append(
            _table(rows, ["field", "count", "mean", "min", "max", "last"]))
    return "\n".join(chunks)


def compare(a: Dict[str, Dict[str, dict]],
            b: Dict[str, Dict[str, dict]]) -> Dict[str, Dict[str, dict]]:
    """Per-kind/field mean-vs-mean diff for every field both runs have."""
    out: Dict[str, Dict[str, dict]] = {}
    for kind in sorted(set(a) & set(b)):
        fields = sorted(set(a[kind]) & set(b[kind]))
        if not fields:
            continue
        out[kind] = {}
        for key in fields:
            ma, mb = a[kind][key]["mean"], b[kind][key]["mean"]
            delta = mb - ma
            # A zero baseline has no meaningful relative change: record
            # None (rendered "—"), never a `+nan%` column; the absolute
            # delta still prints.
            pct = (delta / abs(ma) * 100.0) if ma else None
            out[kind][key] = {"mean_a": ma, "mean_b": mb,
                              "delta": delta, "delta_pct": pct}
    return out


def format_compare(name_a: str, name_b: str,
                   diff: Dict[str, Dict[str, dict]],
                   kinds: Optional[Sequence[str]] = None) -> str:
    chunks = [f"compare: A={name_a}  B={name_b}"]
    for kind in sorted(diff):
        if kinds and kind not in kinds:
            continue
        rows = []
        for key, d in sorted(diff[kind].items()):
            pct = d["delta_pct"]
            rows.append([
                key, _fmt(d["mean_a"]), _fmt(d["mean_b"]), _fmt(d["delta"]),
                ("—" if pct is None or pct != pct else f"{pct:+.1f}%"),
            ])
        if rows:
            chunks.append(f"\n[{kind}]")
            chunks.append(_table(
                rows, ["field", "mean_A", "mean_B", "delta", "delta%"]))
    return "\n".join(chunks)


def _lookup_stat(summary: Dict[str, Dict[str, dict]],
                 layers: Dict[str, Dict[str, dict]],
                 check: dict) -> Optional[float]:
    """Resolve one baseline check against a run's aggregates; None when
    the kind/layer/field/stat is absent (reported as a failure — a
    silently vanished counter IS a regression)."""
    stat = str(check.get("stat", "mean"))
    if check.get("layer") is not None:
        fields = layers.get(str(check["layer"]), {})
    else:
        fields = summary.get(str(check.get("kind", "obs")), {})
    entry = fields.get(str(check["field"]))
    if entry is None or stat not in entry:
        return None
    return float(entry[stat])


def _check_id(check: dict) -> str:
    where = (f"layers[{check['layer']}]" if check.get("layer") is not None
             else str(check.get("kind", "obs")))
    return f"{where}.{check['field']}.{check.get('stat', 'mean')}"


def run_gate(run: str, baseline_path: str,
             write: Optional[str] = None) -> int:
    """Diff a run against a committed baseline JSON; 0 pass / 1 fail."""
    try:
        with open(baseline_path) as fh:
            baseline = json.load(fh)
    except (OSError, ValueError) as e:
        print(f"cannot read baseline {baseline_path}: {e}")
        return 2
    checks = baseline.get("checks")
    if not isinstance(checks, list) or not checks:
        print(f"baseline {baseline_path} has no 'checks' list")
        return 2
    try:
        records, bad = load_records(run)
    except OSError as e:
        print(f"cannot read {run}: {e}")
        return 2
    if bad:
        print(f"note: {run}: skipped {bad} malformed line(s)")
    summary = summarize(records)
    layers = summarize_layers(records)
    manifest = extract_manifest(records) or {}

    failures = 0
    rows = []
    for key, expect in sorted((baseline.get("manifest") or {}).items()):
        actual = manifest.get(key)
        ok = actual == expect
        failures += not ok
        rows.append([f"manifest.{key}", json.dumps(expect),
                     json.dumps(actual), "-", "OK" if ok else "FAIL"])
    for check in checks:
        expect = float(check["expect"])
        rtol = float(check.get("rtol", 0.0))
        atol = float(check.get("atol", 0.0))
        tol = atol + rtol * abs(expect)
        actual = _lookup_stat(summary, layers, check)
        if actual is None:
            failures += 1
            rows.append([_check_id(check), _fmt(expect), "missing",
                         _fmt(tol), "FAIL"])
            continue
        ok = abs(actual - expect) <= tol
        failures += not ok
        rows.append([_check_id(check), _fmt(expect), _fmt(actual),
                     _fmt(tol), "OK" if ok else "FAIL"])
    print(f"gate: run={run}  baseline={baseline_path}")
    print(_table(rows, ["check", "expect", "actual", "tol", "status"]))
    print(f"gate: {len(rows) - failures}/{len(rows)} checks passed")

    if write:
        # Regeneration path: keep each check's spec (tolerances, stat,
        # addressing) but re-stamp 'expect' from the run under test, and
        # refresh the pinned manifest keys. Review the diff like code.
        new_checks = []
        for check in checks:
            actual = _lookup_stat(summary, layers, check)
            out = dict(check)
            if actual is not None:
                out["expect"] = actual
            new_checks.append(out)
        new_base = dict(baseline)
        new_base["checks"] = new_checks
        if baseline.get("manifest"):
            new_base["manifest"] = {
                key: manifest.get(key) for key in baseline["manifest"]
            }
        with open(write, "w") as fh:
            json.dump(new_base, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {write}")
    return 1 if failures else 0


def _is_run(target: str) -> bool:
    """Does the target look like a metrics run (vs. a profiler trace)?"""
    if os.path.isdir(target):
        return (os.path.exists(os.path.join(target, "metrics.jsonl"))
                or bool(_shard_paths(target)))
    return target.endswith(".jsonl")


def run_attr(target: str, mode: Optional[str] = None,
             json_out: Optional[str] = None) -> int:
    """``attr`` subcommand: print the paper's T_compute/T_select/T_comm
    table. The target is either a run (metrics.jsonl carrying logged
    "attr" records — the trainer's captures write them) or a profiler trace
    dir/file, which is parsed and attributed on the spot."""
    from gtopkssgd_tpu_torch.obs import trace_attr

    if _is_run(target):
        try:
            records, bad = load_records(target)
        except OSError as e:
            print(f"cannot read {target}: {e}")
            return 2
        recs = [{k: v for k, v in r.items() if k not in _META_FIELDS}
                for r in records if r.get("kind") == "attr"]
        if not recs:
            print(f"{target}: no attr records (pass a trace dir, or log "
                  "one via obs.trace_attr.attribute)")
            return 1
    else:
        try:
            recs = [trace_attr.attribute(target, mode=mode)]
        except (FileNotFoundError, OSError, ValueError) as e:
            print(f"cannot attribute {target}: {e}")
            return 2
    for rec in recs:
        print(trace_attr.format_attr(rec))
    if json_out:
        with open(json_out, "w") as fh:
            json.dump(recs if len(recs) > 1 else recs[0], fh, indent=1,
                      sort_keys=True)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0


def summarize_events(records: Iterable[dict]) -> Dict[str, dict]:
    """{rule: {severity, count, first_step, last_step, last_value,
    threshold, last_message}} over kind=="event" records."""
    by_rule: Dict[str, dict] = {}
    for rec in records:
        if rec.get("kind") != "event":
            continue
        rule = str(rec.get("rule", "?"))
        r = by_rule.setdefault(rule, {
            "severity": rec.get("severity"), "count": 0,
            "first_step": None, "last_step": None, "last_value": None,
            "threshold": rec.get("threshold"), "last_message": None,
        })
        r["count"] += 1
        r["severity"] = rec.get("severity", r["severity"])
        step = rec.get("step")
        if isinstance(step, (int, float)):
            r["first_step"] = (step if r["first_step"] is None
                               else min(r["first_step"], step))
            r["last_step"] = (step if r["last_step"] is None
                              else max(r["last_step"], step))
        r["last_value"] = rec.get("value", r["last_value"])
        r["threshold"] = rec.get("threshold", r["threshold"])
        r["last_message"] = rec.get("message", r["last_message"])
    return by_rule


def format_events(name: str, by_rule: Dict[str, dict]) -> str:
    if not by_rule:
        return f"events: {name}: none recorded"
    rows = []
    for rule in sorted(by_rule):
        r = by_rule[rule]
        rows.append([
            rule, str(r["severity"]), str(r["count"]),
            "-" if r["first_step"] is None else _fmt(r["first_step"]),
            "-" if r["last_step"] is None else _fmt(r["last_step"]),
            "-" if r["last_value"] is None else _fmt(r["last_value"]),
            "-" if r["threshold"] is None else _fmt(r["threshold"]),
        ])
    out = [f"events: {name}",
           _table(rows, ["rule", "severity", "count", "first_step",
                         "last_step", "last_value", "threshold"])]
    for rule in sorted(by_rule):
        msg = by_rule[rule]["last_message"]
        if msg:
            out.append(f"  {rule}: {msg}")
    return "\n".join(out)


def run_events(run: str, json_out: Optional[str] = None) -> int:
    """``events`` subcommand: summarize a run's anomaly stream per rule."""
    try:
        records, bad = load_records(run)
    except OSError as e:
        print(f"cannot read {run}: {e}")
        return 2
    if bad:
        print(f"note: {run}: skipped {bad} malformed line(s)")
    by_rule = summarize_events(records)
    name = os.path.basename(os.path.normpath(run)) or run
    print(format_events(name, by_rule))
    if json_out:
        with open(json_out, "w") as fh:
            json.dump(by_rule, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0


def summarize_recovery(records: Iterable[dict]) -> dict:
    """Resilience view over one run's records: injected faults (kind
    "inject"), recovery actions (kind "recovery"), claimed vs unclaimed
    anomaly events, and the end-of-run summary record's verdict."""
    out = {
        "injected": {},        # fault kind -> {count, first_step, last_step}
        "actions": {},         # action -> {count, rules, first_step, last_step}
        "events_claimed": 0,
        "events_unclaimed": 0,
        "final_status": None,
        "n_recoveries": None,
        "final_step": None,
    }
    for rec in records:
        kind = rec.get("kind")
        step = rec.get("step")
        if kind == "inject":
            f = out["injected"].setdefault(str(rec.get("fault", "?")), {
                "count": 0, "first_step": None, "last_step": None})
            f["count"] += 1
            if isinstance(step, (int, float)):
                f["first_step"] = (step if f["first_step"] is None
                                   else min(f["first_step"], step))
                f["last_step"] = (step if f["last_step"] is None
                                  else max(f["last_step"], step))
        elif kind == "recovery":
            action = str(rec.get("action", "?"))
            if action == "summary":
                out["final_status"] = rec.get("final_status")
                out["n_recoveries"] = rec.get("n_recoveries")
                out["final_step"] = step
                continue
            a = out["actions"].setdefault(action, {
                "count": 0, "rules": {}, "first_step": None,
                "last_step": None})
            a["count"] += 1
            rule = rec.get("rule")
            if rule is not None:
                a["rules"][str(rule)] = a["rules"].get(str(rule), 0) + 1
            if isinstance(step, (int, float)):
                a["first_step"] = (step if a["first_step"] is None
                                   else min(a["first_step"], step))
                a["last_step"] = (step if a["last_step"] is None
                                  else max(a["last_step"], step))
        elif kind == "event":
            if rec.get("claimed"):
                out["events_claimed"] += 1
            else:
                out["events_unclaimed"] += 1
    return out


def format_recovery(name: str, summary: dict) -> str:
    chunks = [f"recovery: {name}"]
    injected = summary["injected"]
    if injected:
        rows = [[fault, str(f["count"]),
                 "-" if f["first_step"] is None else _fmt(f["first_step"]),
                 "-" if f["last_step"] is None else _fmt(f["last_step"])]
                for fault, f in sorted(injected.items())]
        chunks.append(f"\n[inject] ({sum(f['count'] for f in injected.values())} firings)")
        chunks.append(_table(rows, ["fault", "count", "first_step",
                                    "last_step"]))
    actions = summary["actions"]
    if actions:
        rows = []
        for action, a in sorted(actions.items()):
            rules = "  ".join(f"{rule}={n}"
                              for rule, n in sorted(a["rules"].items()))
            rows.append([
                action, str(a["count"]),
                "-" if a["first_step"] is None else _fmt(a["first_step"]),
                "-" if a["last_step"] is None else _fmt(a["last_step"]),
                rules or "-"])
        chunks.append(f"\n[recovery] ({sum(a['count'] for a in actions.values())} actions)")
        chunks.append(_table(rows, ["action", "count", "first_step",
                                    "last_step", "rules"]))
    if not injected and not actions:
        chunks.append("no injected faults or recovery actions recorded")
    claimed, unclaimed = (summary["events_claimed"],
                          summary["events_unclaimed"])
    if claimed or unclaimed:
        chunks.append(f"\nanomaly events: {claimed} claimed by recovery, "
                      f"{unclaimed} unclaimed")
    if summary["final_status"] is not None:
        chunks.append(
            f"final: status={summary['final_status']} "
            f"n_recoveries={summary['n_recoveries']} "
            + ("" if summary["final_step"] is None
               else f"step={_fmt(summary['final_step'])}"))
    return "\n".join(chunks)


def run_recovery(run: str, json_out: Optional[str] = None) -> int:
    """``recovery`` subcommand: the resilience story of one run —
    injected faults, recovery actions by kind, claimed/unclaimed events,
    and the end-of-run verdict."""
    try:
        records, bad = load_records(run)
    except OSError as e:
        print(f"cannot read {run}: {e}")
        return 2
    if bad:
        print(f"note: {run}: skipped {bad} malformed line(s)")
    summary = summarize_recovery(records)
    name = os.path.basename(os.path.normpath(run)) or run
    print(format_recovery(name, summary))
    if json_out:
        with open(json_out, "w") as fh:
            json.dump(summary, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0


def run_timeline(run: str, out: Optional[str] = None) -> int:
    """``timeline`` subcommand: rebuild a chrome-trace timeline from a
    run's metrics.jsonl (markers + counter tracks at recorded wall-clock
    times), validate it, and write it next to the run."""
    from gtopkssgd_tpu_torch.obs.timeline import (
        timeline_from_records,
        validate_timeline,
    )

    try:
        records, bad = load_records(run)
    except OSError as e:
        print(f"cannot read {run}: {e}")
        return 2
    if bad:
        print(f"note: {run}: skipped {bad} malformed line(s)")
    name = os.path.basename(os.path.normpath(run)) or run
    doc = timeline_from_records(records, label=name)
    problems = validate_timeline(doc)
    if out is None:
        base = run if os.path.isdir(run) else os.path.dirname(run) or "."
        out = os.path.join(base, "timeline.json")
    with open(out, "w") as fh:
        json.dump(doc, fh)
        fh.write("\n")
    n = sum(1 for e in doc["traceEvents"] if e.get("ph") != "M")
    print(f"timeline: {name}: {n} events -> {out}"
          + (" (open in chrome://tracing or ui.perfetto.dev)"))
    for p in problems:
        print(f"invalid: {p}")
    return 1 if problems else 0


def format_fleet(merged: dict, kinds: Optional[Sequence[str]] = None,
                 max_rows: int = 0) -> str:
    """The fleet view: per-(src, step, field) stat rows, then straggler
    attribution, then fired events. ``max_rows`` > 0 truncates the stat
    table (watch mode); 0 prints everything."""
    chunks = [f"fleet: ranks={merged['ranks']} "
              f"shards={len(merged['shards'])}"]
    man = merged.get("manifest") or {}
    if man:
        bits = [f"{key}={man[key]}" for key in
                ("compression", "nworkers", "process_count", "config_hash")
                if man.get(key) is not None]
        if bits:
            chunks.append("  " + "  ".join(bits))
    rows = merged["rows"]
    if kinds:
        rows = [r for r in rows if r["src"] in kinds]
    table = []
    shown = rows if max_rows <= 0 else rows[-max_rows:]
    for r in shown:
        worst = (max(r["skew"], key=lambda rk: abs(r["skew"][rk]))
                 if r["skew"] else "-")
        table.append([r["src"], _fmt(r["step"]), r["field"],
                      str(r["n_ranks"]), _fmt(r["min"]), _fmt(r["median"]),
                      _fmt(r["max"]), _fmt(r["std"]), _fmt(r["skew_max"]),
                      str(worst)])
    if table:
        chunks.append(f"\n[fleet] ({len(rows)} merged rows"
                      + (f", last {len(shown)}" if len(shown) < len(rows)
                         else "") + ")")
        chunks.append(_table(table, ["src", "step", "field", "n_ranks",
                                     "min", "median", "max", "std",
                                     "skew_max", "worst"]))
    stragglers = merged.get("stragglers") or []
    if stragglers:
        st = [[_fmt(s["step"]), f"r{s['slowest_rank']}",
               _fmt(s["behind_median_s"]), _fmt(s["lag_s"]),
               _fmt(s["ewma_lag_s"]),
               "persistent" if s["persistent"] else "transient",
               str(s.get("stage") or "-")]
              for s in stragglers]
        chunks.append(f"\n[straggler] (src={stragglers[0]['src']}; lag = "
                      "arrival behind first rank at each step's record; "
                      "stage = the slowest rank's local critical stage)")
        chunks.append(_table(st, ["step", "slowest", "behind_median_s",
                                  "lag_s", "ewma_lag_s", "class",
                                  "stage"]))
        persistent = [s for s in stragglers if s["persistent"]]
        if persistent:
            worst = persistent[-1]
            chunks.append(
                f"persistent straggler: rank {worst['slowest_rank']} "
                f"(EWMA lag {_fmt(worst['ewma_lag_s'])}s over "
                f"{len(persistent)} flagged steps)")
    crit = merged.get("critpath") or []
    if crit:
        counts: Dict[str, int] = {}
        for r in crit:
            st = r.get("crit_stage")
            if st:
                counts[st] = counts.get(st, 0) + 1
        modal = (max(sorted(counts), key=lambda s: counts[s])
                 if counts else None)
        mean_frac = sum(float(r.get("crit_frac", 0.0))
                        for r in crit) / len(crit)
        chunks.append(f"\n[critpath] {len(crit)} joined step(s)  "
                      f"modal critical stage: {modal}  "
                      f"mean crit_frac={mean_frac:.4f}  "
                      "(report critpath for the full chain)")
    events = merged.get("events") or []
    if events:
        by_rule: Dict[str, int] = {}
        for ev in events:
            by_rule[ev["rule"]] = by_rule.get(ev["rule"], 0) + 1
        chunks.append("\n[events] "
                      + "  ".join(f"{rule}={n}"
                                  for rule, n in sorted(by_rule.items())))
    return "\n".join(chunks)


def run_fleet(targets: Sequence[str], kinds: Optional[Sequence[str]],
              json_out: Optional[str] = None,
              allow_mismatch: bool = False) -> int:
    """``fleet`` subcommand: merge rank shards (one or many dirs/files),
    print per-step cross-rank stats + straggler attribution."""
    from gtopkssgd_tpu_torch.obs import fleet

    try:
        merged = fleet.merge(list(targets),
                             kinds=tuple(kinds) if kinds
                             else fleet.DEFAULT_KINDS,
                             allow_mismatch=allow_mismatch)
    except (OSError, ValueError) as e:
        print(f"cannot merge {list(targets)}: {e}")
        return 2
    if merged["n_malformed"]:
        print(f"note: skipped {merged['n_malformed']} malformed line(s)")
    print(format_fleet(merged, kinds=None))
    if json_out:
        with open(json_out, "w") as fh:
            json.dump(merged, fh, indent=1, sort_keys=True, default=str)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0


def run_critpath(targets: Sequence[str], json_out: Optional[str] = None,
                 allow_mismatch: bool = False,
                 halt_on: Optional[str] = None) -> int:
    """``critpath`` subcommand: join per-rank ``critpath`` stage-interval
    records (obs/critpath.py) across shards into the global per-step
    critical path — which (rank, stage) chain bounds each step, how much
    of T_comm was wire vs skew-wait, and where each rank's blocked time
    went. ``halt_on`` arms the ``critpath_shift`` rule exactly like the
    trainer's --obs-halt-on: a modal-stage shift exits HALT_EXIT_CODE
    after its event row is printed."""
    from gtopkssgd_tpu_torch.obs import critpath as _critpath
    from gtopkssgd_tpu_torch.obs import fleet
    from gtopkssgd_tpu_torch.obs.events import (
        HALT_EXIT_CODE,
        AnomalyHalt,
        AnomalyMonitor,
    )

    try:
        shards = fleet.resolve_targets(list(targets))
        records_by_rank, bad = fleet.load_shards(shards)
        fleet.validate_shards(records_by_rank,
                              allow_mismatch=allow_mismatch)
    except (OSError, ValueError) as e:
        print(f"cannot merge {list(targets)}: {e}")
        return 2
    if bad:
        print(f"note: skipped {bad} malformed line(s)")
    monitor = AnomalyMonitor(halt_on=halt_on)
    try:
        rows, budgets = fleet.critpath_rows(records_by_rank,
                                            monitor=monitor)
        halted = None
    except AnomalyHalt as e:
        halted = e.event
        rows, budgets = [], {}
    if halted is not None:
        print(f"critpath: HALT on {halted['rule']} at step "
              f"{halted.get('step')}: {halted.get('message')}")
        return HALT_EXIT_CODE
    if not rows:
        print("critpath: no critpath records (run with --obs-critpath, "
              "or the shards predate the stage-interval plane)")
        return 1
    print(f"critpath: ranks={sorted(records_by_rank)} "
          f"steps={len(rows)}")
    print(_critpath.format_critpath(rows, budgets))
    events = list(monitor.events)
    if events:
        by_rule: Dict[str, int] = {}
        for ev in events:
            by_rule[ev["rule"]] = by_rule.get(ev["rule"], 0) + 1
        print("\n[events] " + "  ".join(
            f"{rule}={n}" for rule, n in sorted(by_rule.items())))
    if json_out:
        with open(json_out, "w") as fh:
            json.dump({"rows": rows, "budgets": budgets,
                       "events": events}, fh, indent=1, sort_keys=True,
                      default=str)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0


def run_goodput(targets: Sequence[str], json_out: Optional[str] = None,
                allow_mismatch: bool = False, advise: bool = False,
                compare: Optional[str] = None) -> int:
    """``goodput`` subcommand: per-rank goodput/badput decomposition
    (obs/goodput.py) — category table, per-rank goodput bars, the
    whole-fleet wall-weighted roll-up; ``--compare OTHER`` diffs this
    run's fleet decomposition against another run's (the chaos-vs-clean
    view); ``--advise`` prints the eviction hint (which rank's badput
    drags furthest below the fleet median, and what evicting it would
    recover)."""
    from gtopkssgd_tpu_torch.obs import fleet
    from gtopkssgd_tpu_torch.obs import goodput as _goodput

    try:
        shards = fleet.resolve_targets(list(targets))
        records_by_rank, bad = fleet.load_shards(shards)
        fleet.validate_shards(records_by_rank,
                              allow_mismatch=allow_mismatch)
    except (OSError, ValueError) as e:
        print(f"cannot merge {list(targets)}: {e}")
        return 2
    if bad:
        print(f"note: skipped {bad} malformed line(s)")
    decomp = _goodput.fold_shards(records_by_rank)
    if not decomp:
        print("goodput: no goodput records and nothing to synthesize "
              "from (run with --obs-goodput, the default)")
        return 1
    fleet_rec = _goodput.fleet_decomposition(decomp)
    cmp_decomp = None
    if compare:
        try:
            cshards = fleet.resolve_targets([compare])
            crecs, cbad = fleet.load_shards(cshards)
            if cbad:
                print(f"note: {compare}: skipped {cbad} malformed "
                      "line(s)")
            cmp_decomp = _goodput.fold_shards(crecs) or None
        except (OSError, ValueError) as e:
            print(f"cannot read compare run {compare}: {e}")
            return 2
    hint = _goodput.advise(decomp) if advise else None
    print(f"goodput: ranks={sorted(decomp)}")
    print(_goodput.format_goodput(decomp, fleet=fleet_rec,
                                  compare=cmp_decomp, hint=hint))
    if advise and hint is None:
        print("advise: no outlier — every rank within margin of the "
              "fleet median goodput_frac")
    if json_out:
        with open(json_out, "w") as fh:
            json.dump({"by_rank": decomp, "fleet": fleet_rec,
                       "compare": cmp_decomp, "advise": hint},
                      fh, indent=1, sort_keys=True, default=str)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0


def run_watch(targets: Sequence[str], interval: float = 2.0,
              iterations: Optional[int] = None, out=None) -> int:
    """``watch`` subcommand: tail-follow one or many shards, printing a
    refreshing per-rank summary block per poll. Incremental — each poll
    reads only bytes appended since the last (line-buffered writers make
    whole records visible mid-run). ``iterations`` bounds the loop for
    tests/scripting; the default runs until interrupted."""
    import sys
    out = out or sys.stdout

    # rank -> [path, offset, n_records, n_bad, last_rec_by_kind,
    #          last_two_record_times]
    state: Dict[int, list] = {}

    def discover():
        for target in targets:
            if os.path.isdir(target):
                for path in _shard_paths(target) or [
                        os.path.join(target, "metrics.jsonl")]:
                    r = shard_rank(path)
                    state.setdefault(r if r is not None else 0,
                                     [path, 0, 0, 0, {}, []])
            else:
                r = shard_rank(target)
                state.setdefault(r if r is not None else 0,
                                 [target, 0, 0, 0, {}, []])

    n_polls = 0
    try:
        while True:
            discover()  # shards appear as ranks start up
            for rank in sorted(state):
                st = state[rank]
                path, offset = st[0], st[1]
                try:
                    with open(path) as fh:
                        fh.seek(offset)
                        chunk = fh.read()
                        st[1] = fh.tell()
                except OSError:
                    continue
                recs, bad = _parse_lines(chunk.splitlines())
                st[2] += len(recs)
                st[3] += bad
                for rec in recs:
                    st[4][str(rec.get("kind"))] = rec
                    ts = rec.get("time")
                    if isinstance(ts, (int, float)):
                        st[5].append(float(ts))
                        del st[5][:-2]
            stamp = _time.strftime("%H:%M:%S")
            print(f"watch @ {stamp}  ({len(state)} rank(s))", file=out)
            # Live straggler view: each rank's latest per-step record
            # arrival vs the cross-rank median — the same
            # behind_median_s the fleet straggler rows report, computed
            # over whatever each shard has flushed so far.
            arrivals: Dict[int, float] = {}
            for rank in sorted(state):
                last = state[rank][4]
                for kind in ("train", "obs", "eval"):
                    rec = last.get(kind)
                    if rec is not None and isinstance(
                            rec.get("time"), (int, float)):
                        arrivals[rank] = float(rec["time"])
                        break
            med_arrival = None
            if len(arrivals) >= 2:
                vals = sorted(arrivals.values())
                mid = len(vals) // 2
                med_arrival = (vals[mid] if len(vals) % 2
                               else 0.5 * (vals[mid - 1] + vals[mid]))
            for rank in sorted(state):
                path, _, n, bad, last = state[rank][:5]
                times = state[rank][5]
                latest = None
                for kind in ("train", "obs", "eval"):
                    if kind in last:
                        latest = last[kind]
                        break
                bits = [f"rank {rank}", f"records={n}"]
                if latest is not None:
                    if latest.get("step") is not None:
                        bits.append(f"step={_fmt(latest['step'])}")
                    for key in ("loss", "achieved_density", "wire_bytes"):
                        if isinstance(latest.get(key), (int, float)):
                            bits.append(f"{key}={_fmt(latest[key])}")
                if med_arrival is not None and rank in arrivals:
                    bits.append(
                        "behind_median_s="
                        f"{_fmt(arrivals[rank] - med_arrival)}")
                cp = last.get("critpath")
                if cp is not None and cp.get("crit_stage"):
                    # this rank's local critical stage (latest critpath
                    # record) — why it is slow, not just that it is.
                    bits.append(f"crit_stage={cp['crit_stage']}")
                gp = last.get("goodput")
                if gp is not None and isinstance(
                        gp.get("goodput_frac"), (int, float)):
                    # latest cumulative ledger record (--obs-goodput):
                    # this rank's productive share of wall so far.
                    bits.append(f"goodput_frac={_fmt(gp['goodput_frac'])}")
                mem = last.get("mem")
                if mem is not None:
                    # space-plane gauges (--obs-mem): same fields the
                    # OpenMetrics exporter serves as gtopk_mem_*.
                    for key in ("live_bytes", "bytes_in_use",
                                "recompile_count"):
                        if isinstance(mem.get(key), (int, float)):
                            bits.append(f"{key}={_fmt(mem[key])}")
                lm = last.get("linkmap")
                if lm is not None and lm.get("worst_link"):
                    # the rank's slowest peer hop (latest weather-map
                    # record) and how far it sits above its link median.
                    x = lm.get("worst_over_median_x")
                    bits.append(
                        f"slowest_peer={lm['worst_link']}"
                        + (f"({_fmt(x)}x)"
                           if isinstance(x, (int, float)) else ""))
                if times:
                    # freshness: seconds since the shard's newest record;
                    # STALE once the gap exceeds 3x the rank's own log
                    # cadence (last inter-record interval) — a wedged or
                    # dead rank keeps serving its last gauges otherwise.
                    age = max(0.0, _time.time() - times[-1])
                    bits.append(f"age_s={_fmt(age)}")
                    cadence = (times[-1] - times[-2]
                               if len(times) >= 2 else None)
                    if cadence and cadence > 0 and age > 3 * cadence:
                        bits.append("STALE")
                ev = last.get("event")
                if ev is not None:
                    bits.append(f"last_event={ev.get('rule')}")
                if bad:
                    bits.append(f"malformed={bad}")
                if n == 0:
                    bits.append("(no records yet)")
                print("  " + "  ".join(bits), file=out)
            out.flush()
            n_polls += 1
            if iterations is not None and n_polls >= iterations:
                return 0
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def run_ledger(targets: Sequence[str], json_out: Optional[str] = None,
               alpha_ms: Optional[float] = None,
               beta_gbps: Optional[float] = None,
               probe_dir: Optional[str] = None) -> int:
    """``ledger`` subcommand: predicted-vs-measured comm rows over a
    run's (or fleet's) records."""
    from gtopkssgd_tpu_torch.obs import ledger

    records = []
    for target in targets:
        try:
            recs, bad = load_records(target)
        except OSError as e:
            print(f"cannot read {target}: {e}")
            return 2
        if bad:
            print(f"note: {target}: skipped {bad} malformed line(s)")
        records.extend(recs)
    rows = ledger.ledger_rows(records, alpha_ms=alpha_ms,
                              beta_gbps=beta_gbps, probe_dir=probe_dir)
    if not rows:
        print("ledger: no joinable records (need a manifest with "
              "compression/nworkers/num_params plus attr or obs "
              "wire_bytes records)")
        return 1
    base = rows[0]
    bucketing = base.get("bucketing", "concat")
    bucket_note = ("" if bucketing in (None, "concat") else
                   f" bucketing={bucketing} "
                   f"n_buckets={base.get('n_buckets')}")
    print(f"ledger: mode={base['mode']} p={base['p']} n={base['n']} "
          f"k={base['k']} codec={base.get('codec', 'fp32')}"
          f"{bucket_note}  alpha_ms={base['alpha_ms']} "
          f"beta_gbps={base['beta_gbps']} ici_size={base['ici_size']} "
          f"(fit: {base['fit_source']})")
    prov = _fit_provenance_line(records)
    if prov:
        print(prov)
    print(f"predicted comm: {_fmt(base['predicted_comm_ms'])} ms/step")
    # Codec-bytes audit: modeled vs measured wire bytes per rank (the
    # wire_bytes rows carry both sides of the join).
    wire_rows = [r for r in rows if r.get("source") == "wire_bytes"
                 and isinstance(r.get("predicted_wire_bytes"),
                                (int, float))]
    if wire_rows:
        by_rank = {}
        for r in wire_rows:
            by_rank.setdefault(r.get("rank", 0), []).append(r)
        parts = []
        for rk in sorted(by_rank):
            rws = by_rank[rk]
            meas = sum(float(r["measured_wire_bytes"])
                       for r in rws) / len(rws)
            pred = float(rws[0]["predicted_wire_bytes"])
            parts.append(f"r{rk}: {_fmt(pred)}B model / "
                         f"{_fmt(meas)}B measured")
        print(f"codec bytes ({base.get('codec', 'fp32')}): "
              + "  ".join(parts))
    summary = ledger.summarize_ledger(rows)
    table = []
    for source in sorted(summary):
        s = summary[source]
        worst = "  ".join(f"r{rk}={v}" for rk, v in
                          s["worst_ranks"].items())
        table.append([source, str(s["count"]), _fmt(s["mean_ratio"]),
                      _fmt(s["min_ratio"]), _fmt(s["max_ratio"]), worst])
    print(_table(table, ["source", "rows", "mean_ratio", "min_ratio",
                         "max_ratio", "worst_ranks"]))
    if json_out:
        with open(json_out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1,
                      sort_keys=True)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0


def run_linkmap(targets: Sequence[str],
                json_out: Optional[str] = None) -> int:
    """``linkmap`` subcommand: join one or many runs' per-rank
    "linkmap" records into the fleet network weather map — per-(axis,
    peer) EWMA latency/bandwidth with endpoint averaging, the worst
    link vs the fleet median, and the per-axis calib fit lines when the
    stream carries dotted per-axis calib fields."""
    from gtopkssgd_tpu_torch.obs import linkmap as _linkmap

    records = []
    for target in targets:
        try:
            recs, bad = load_records(target)
        except OSError as e:
            print(f"cannot read {target}: {e}")
            return 2
        if bad:
            print(f"note: {target}: skipped {bad} malformed line(s)")
        records.extend(recs)
    summary = _linkmap.summarize_linkmap(records)
    print(_linkmap.format_linkmap(summary))
    if json_out:
        with open(json_out, "w") as fh:
            json.dump(summary, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0 if summary["rows"] else 1


def run_forecast(targets: Sequence[str],
                 json_out: Optional[str] = None,
                 search_dir: Optional[str] = None,
                 forecast_targets: Optional[str] = None) -> int:
    """``forecast`` subcommand: the scale-out forecast view
    (obs/forecast.py) — hindcast error against the run's own measured
    step time, the per-P recommendation grid with resid-derived
    uncertainty columns, and the tree->balanced crossover P. A run that
    logged live ``forecast`` records is reported from its last one;
    otherwise the view is rebuilt offline from the stream's manifest +
    critpath + calib + linkmap records (and the fit-artifact lookup
    under ``--probe-dir``)."""
    from gtopkssgd_tpu_torch.obs import forecast as _forecast

    records = []
    for target in targets:
        try:
            recs, bad = load_records(target)
        except OSError as e:
            print(f"cannot read {target}: {e}")
            return 2
        if bad:
            print(f"note: {target}: skipped {bad} malformed line(s)")
        records.extend(recs)
    ts = None
    if forecast_targets:
        try:
            ts = tuple(int(t) for t in forecast_targets.split(",")
                       if t.strip())
        except ValueError:
            print(f"--targets must be comma-separated worker counts, "
                  f"got {forecast_targets!r}")
            return 2
    summary = _forecast.summarize_forecast(records, search_dir=search_dir,
                                           targets=ts)
    print(_forecast.format_forecast(summary))
    if json_out:
        payload = {k: v for k, v in summary.items()}
        if isinstance(payload.get("recs"), dict):
            payload["recs"] = {str(p): row for p, row
                               in payload["recs"].items()}
        with open(json_out, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0 if summary.get("rows") else 1


def _fit_provenance_line(records: Iterable[dict]) -> Optional[str]:
    """The manifest's stamped comm-model provenance ("which comm model
    priced this plan"), or None for runs that predate the stamp. Printed
    by the plan and ledger headers — including when the source is a
    calib_fit artifact from a previous calibrated run."""
    man = extract_manifest(records)
    if man is None or man.get("comm_fit_source") is None:
        return None
    return (f"manifest fit: {man['comm_fit_source']} "
            f"(alpha_ms={man.get('comm_fit_alpha_ms')} "
            f"beta_gbps={man.get('comm_fit_beta_gbps')})")


def run_history(registry_dir: str, config_hash: Optional[str] = None,
                json_out: Optional[str] = None) -> int:
    """``history`` subcommand: the registry's cross-run trend table
    (obs/registry.py runs.jsonl), offline — no live run needed."""
    from gtopkssgd_tpu_torch.obs import registry as _registry

    entries, bad = _registry.load_registry(registry_dir)
    if bad:
        print(f"note: skipped {bad} malformed registry line(s)")
    if not entries:
        print(f"history: no registry entries under {registry_dir} "
              f"(runs append via --registry {registry_dir})")
        return 1
    rows = _registry.history_rows(entries, config_hash=config_hash)
    if not rows:
        print(f"history: no entries match config_hash={config_hash}")
        return 1
    print(f"history: {len(rows)} run(s)"
          + (f" with config_hash={config_hash}" if config_hash else
             f" across {len({e.get('config_hash') for e in entries})} "
             "config(s)"))
    print(_table(rows, _registry.HISTORY_HEADER))
    if json_out:
        with open(json_out, "w") as fh:
            json.dump({"entries": entries}, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0


def run_regress(run: str, registry_dir: str,
                allow_mismatch: bool = False,
                json_out: Optional[str] = None) -> int:
    """``regress`` subcommand: summarize the run under test from its
    shards, diff it against the most recent same-config registry entry
    under REGRESS_CHECKS tolerances. Exit contract matches ``gate``:
    0 within tolerance, 1 regression, 2 usage (unreadable run, empty
    registry, or no comparable baseline without --allow-mismatch)."""
    from gtopkssgd_tpu_torch.obs import registry as _registry

    try:
        records, bad = load_records(run)
    except OSError as e:
        print(f"cannot read {run}: {e}")
        return 2
    if bad:
        print(f"note: skipped {bad} malformed line(s)")
    entry = _registry.run_summary(records)
    if entry is None:
        print("regress: run has no manifest record — nothing to key the "
              "baseline lookup on")
        return 2
    entries, rbad = _registry.load_registry(registry_dir)
    if rbad:
        print(f"note: skipped {rbad} malformed registry line(s)")
    if not entries:
        print(f"regress: no registry entries under {registry_dir}")
        return 2
    baseline = _registry.pick_baseline(entry, entries,
                                       allow_mismatch=allow_mismatch)
    if baseline is None:
        print(f"regress: no registry entry matches config_hash="
              f"{entry.get('config_hash')} (rerun with --allow-mismatch "
              "to compare against the newest entry of any config)")
        return 2
    if baseline.get("config_hash") != entry.get("config_hash"):
        print(f"note: baseline config_hash "
              f"{baseline.get('config_hash')} != run's "
              f"{entry.get('config_hash')} (--allow-mismatch)")
    rows, failures = _registry.regress(entry, baseline)
    print(f"regress: {run} vs registry entry "
          f"(config={baseline.get('config_hash', '?')}, "
          f"git={baseline.get('git_sha', '?')})")
    print(_table(rows, _registry.REGRESS_HEADER))
    checked = sum(1 for r in rows if r[-1] != "new")
    print(f"regress: {checked - failures}/{checked} checks passed")
    if json_out:
        with open(json_out, "w") as fh:
            json.dump({"current": entry, "baseline": baseline,
                       "failures": failures}, fh, indent=1,
                      sort_keys=True)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 1 if failures else 0


def build_gate_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gtopkssgd_tpu_torch.obs.report gate",
        description="Diff a run against a committed baseline JSON; exit "
                    "nonzero on regression.",
    )
    p.add_argument("run", help="an --out-dir or a metrics.jsonl path")
    p.add_argument("--baseline", required=True,
                   help="baseline JSON with a 'checks' list and optional "
                        "'manifest' exact-match dict")
    p.add_argument("--write", default=None,
                   help="write a regenerated baseline (same check specs, "
                        "expectations re-stamped from this run) here")
    return p


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gtopkssgd_tpu_torch.obs.report",
        description="Aggregate metrics.jsonl runs; compare two for "
                    "regression triage.",
    )
    p.add_argument("runs", nargs="+",
                   help="1 or 2 runs: an --out-dir (containing "
                        "metrics.jsonl) or a .jsonl path")
    p.add_argument("--kinds", default=None,
                   help="comma-separated record kinds to report "
                        "(default: all present)")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the aggregate (or diff) as JSON here")
    return p


def run_plan(run: str, json_out: Optional[str] = None) -> int:
    """``plan`` subcommand: the comm-planner decision record — which
    wire plan the run chose, why (every candidate's modeled comm_ms and
    per-step wire bytes), and the alpha-beta inputs the scores used."""
    try:
        records, bad = load_records(run)
    except OSError as e:
        print(f"cannot read {run}: {e}")
        return 2
    if bad:
        print(f"note: skipped {bad} malformed line(s)")
    decisions = [r for r in records if r.get("kind") == "plan"
                 and isinstance(r.get("candidates"), list)]
    bucket_recs = [r for r in records if r.get("kind") == "bucket"
                   and isinstance(r.get("bucket_sizes"), list)]
    if not decisions and not bucket_recs:
        print("plan: no planner decision record (dense or single-device "
              "runs have no sparse wire to plan; pre-planner runs "
              "predate the record)")
        return 1
    prov = _fit_provenance_line(records)
    if prov:
        print(prov)
    # The space plane next to the time plane: with --obs-mem on the
    # card, the allocator's peak over the first step of each shape.
    comp = summarize_compile(records)
    if comp["peak_hbm_bytes"] is not None:
        print(f"memory: peak allocated {_fmt(comp['peak_hbm_bytes'])} "
              f"bytes over {len(comp['shapes'])} dispatch shape(s) "
              "(obs.memwatch compile records)")
    for rec in decisions:
        pin = rec.get("pin", "auto")
        how = f"pinned via --comm-plan {pin}" if pin != "auto" else (
            "auto-selected (cheapest modeled comm_ms; historical "
            "schedule wins ties)")
        print(f"plan: {rec.get('plan')} (schedule={rec.get('schedule')}"
              f", wire_mode={rec.get('wire_mode')}, pipeline="
              f"{rec.get('pipeline', 'serial')}) for mode="
              f"{rec.get('mode')} — {how}")
        print(f"inputs: p={rec.get('p')} n={rec.get('n')} k={rec.get('k')}"
              f" codec={rec.get('codec')} ici_size={rec.get('ici_size')}"
              f"  alpha_ms={rec.get('alpha_ms')} "
              f"beta_gbps={rec.get('beta_gbps')} "
              f"ici_gbps={rec.get('ici_gbps')} "
              f"(fit: {rec.get('fit_source')})")
        rows = []
        # Span columns appear once candidates carry them (post-pipeline
        # planner); older records print the comm-only table unchanged.
        have_spans = any(c.get("span_serial_ms") is not None
                         for c in rec["candidates"])
        for c in rec["candidates"]:
            mark = "*" if c.get("name") == rec.get("plan") else ""
            row = [f"{c.get('name')}{mark}",
                   str(c.get('schedule')),
                   _fmt(c.get('comm_ms')),
                   _fmt(c.get('wire_bytes'))]
            if have_spans:
                row += [_fmt(c.get('span_serial_ms')),
                        _fmt(c.get('span_overlap_ms'))]
            rows.append(row)
        header = ["candidate", "schedule", "comm_ms", "wire_bytes/step"]
        if have_spans:
            header += ["span_serial_ms", "span_overlap_ms"]
        print(_table(rows, header))
    # Bucket plan (parallel.bucketing): the partition the run used, a
    # row a bucket (its leaves, elements and k).
    for rec in bucket_recs:
        sizes, ks = rec["bucket_sizes"], rec.get("bucket_ks") or []
        bounds = rec.get("bucket_boundaries") or []
        print(f"buckets: {rec.get('buckets')} -> B={len(sizes)}"
              + (f" over L={bounds[-1]} leaves" if bounds else "")
              + f"  pipeline={rec.get('pipeline')}")
        rows = []
        for b, n_b in enumerate(sizes):
            leaves = (f"{bounds[b]}-{bounds[b + 1]}"
                      if len(bounds) > b + 1 else "-")
            rows.append([str(b), leaves, str(n_b),
                         str(ks[b]) if b < len(ks) else "-"])
        print(_table(rows, ["bucket", "leaves", "elems", "k"]))
    if json_out:
        with open(json_out, "w") as fh:
            json.dump({"decisions": decisions, "buckets": bucket_recs},
                      fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0


# Fields a compile-shape row carries into summaries and the JSON dump:
# what the port's "compile" records hold (obs.memwatch: the first step's
# seconds, FlopCounterMode's FLOPs, the allocator's peak on the card).
_COMPILE_ROW_FIELDS = ("step", "shape_index", "shape_key", "flops",
                       "peak_hbm_bytes", "compile_s")

# The memory-plane anomaly rules (obs/events.py) the mem report calls out.
_MEM_RULES = ("recompile_storm", "device_mem_leak", "hbm_headroom")


def summarize_compile(records: Iterable[dict]) -> dict:
    """Compile-plane view over one run's records: one row a dispatch
    shape ("compile" records, obs/memwatch.py), the recompiles the watch
    caught, the largest first-step peak and the summed first-step
    seconds."""
    out = {
        "shapes": [],          # one row per distinct dispatch shape
        "recompiles": [],      # executable-count growth events
        "recompile_count": 0,
        "peak_hbm_bytes": None,
        "total_compile_s": None,
        "storm_events": 0,
    }
    for rec in records:
        kind = rec.get("kind")
        if kind == "compile":
            if rec.get("event") == "recompile":
                out["recompiles"].append(
                    {k: rec.get(k) for k in ("step", "cache_size",
                                             "recompile_count",
                                             "compile_events")})
                if isinstance(rec.get("recompile_count"), (int, float)):
                    out["recompile_count"] = max(
                        out["recompile_count"], int(rec["recompile_count"]))
            else:
                out["shapes"].append(
                    {k: rec.get(k) for k in _COMPILE_ROW_FIELDS})
        elif kind == "event" and rec.get("rule") == "recompile_storm":
            out["storm_events"] += 1
    peaks = [s["peak_hbm_bytes"] for s in out["shapes"]
             if isinstance(s.get("peak_hbm_bytes"), (int, float))]
    if peaks:
        out["peak_hbm_bytes"] = max(peaks)
    vals = [s["compile_s"] for s in out["shapes"]
            if isinstance(s.get("compile_s"), (int, float))]
    if vals:
        out["total_compile_s"] = round(sum(vals), 4)
    return out


def format_compile(name: str, summary: dict) -> str:
    chunks = [f"compile: {name}"]
    shapes = summary["shapes"]
    if shapes:
        rows = []
        for s in shapes:
            key = str(s.get("shape_key") or "-")
            if len(key) > 40:
                key = key[:37] + "..."
            rows.append([
                "-" if s.get("shape_index") is None
                else str(s["shape_index"]),
                _opt(s.get("step")), _opt(s.get("flops")),
                _opt(s.get("peak_hbm_bytes")), _opt(s.get("compile_s")),
                key])
        chunks.append(f"\n[shapes] ({len(shapes)} distinct dispatch "
                      "shape(s))")
        chunks.append(_table(rows, ["idx", "step", "flops", "peak_alloc",
                                    "compile_s", "shape_key"]))
    else:
        chunks.append("no compile records (run without --obs-mem)")
    recompiles = summary["recompiles"]
    if recompiles:
        rows = [[_opt(r.get("step")), _opt(r.get("cache_size")),
                 _opt(r.get("recompile_count")),
                 _opt(r.get("compile_events"))] for r in recompiles]
        chunks.append(f"\n[recompiles] ({len(recompiles)} executable-count "
                      "growth event(s))")
        chunks.append(_table(rows, ["step", "cache_size",
                                    "recompile_count", "compile_events"]))
    tail = [f"recompile_count={summary['recompile_count']}"]
    if summary["storm_events"]:
        tail.append(f"recompile_storm events={summary['storm_events']}")
    if summary["peak_hbm_bytes"] is not None:
        tail.append(f"peak_hbm_bytes={_fmt(summary['peak_hbm_bytes'])}")
    if summary["total_compile_s"] is not None:
        tail.append(f"total compile_s={_fmt(summary['total_compile_s'])}")
    chunks.append("\n" + "  ".join(tail))
    return "\n".join(chunks)


def run_compile(run: str, json_out: Optional[str] = None) -> int:
    """``compile`` subcommand: the first step of each dispatch shape and
    the recompile-watch events of one run."""
    try:
        records, bad = load_records(run)
    except OSError as e:
        print(f"cannot read {run}: {e}")
        return 2
    if bad:
        print(f"note: {run}: skipped {bad} malformed line(s)")
    summary = summarize_compile(records)
    name = os.path.basename(os.path.normpath(run)) or run
    print(format_compile(name, summary))
    if json_out:
        with open(json_out, "w") as fh:
            json.dump(summary, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0


def summarize_mem(records: Iterable[dict]) -> dict:
    """Memory-plane view over one run's records: the sampled "mem"
    windows (the allocator's live bytes and count, reserved bytes against
    the card's memory; on the CPU the live tensors' storages by dtype)
    plus the three mem-plane anomaly rules."""
    out = {
        "samples": 0,
        "first_step": None, "last_step": None,
        "live_bytes_first": None, "live_bytes_last": None,
        "live_bytes_max": None, "live_count_last": None,
        "by_dtype": {},        # last sample's live bytes per dtype
        "bytes_in_use_last": None, "peak_bytes_in_use": None,
        "bytes_limit": None, "headroom_frac_max": None,
        "recompile_count": 0,
        "rules": {},           # mem-plane rule -> firings
    }
    for rec in records:
        kind = rec.get("kind")
        if kind == "event" and rec.get("rule") in _MEM_RULES:
            rule = str(rec["rule"])
            out["rules"][rule] = out["rules"].get(rule, 0) + 1
            continue
        if kind != "mem":
            continue
        out["samples"] += 1
        step = rec.get("step")
        if isinstance(step, (int, float)):
            if out["first_step"] is None:
                out["first_step"] = step
            out["last_step"] = step
        lb = rec.get("live_bytes")
        if isinstance(lb, (int, float)):
            if out["live_bytes_first"] is None:
                out["live_bytes_first"] = lb
            out["live_bytes_last"] = lb
            out["live_bytes_max"] = (lb if out["live_bytes_max"] is None
                                     else max(out["live_bytes_max"], lb))
        if isinstance(rec.get("live_count"), (int, float)):
            out["live_count_last"] = rec["live_count"]
        out["by_dtype"] = {
            k[len("live_bytes_"):]: v for k, v in rec.items()
            if k.startswith("live_bytes_") and isinstance(v, (int, float))
        } or out["by_dtype"]
        if isinstance(rec.get("bytes_in_use"), (int, float)):
            out["bytes_in_use_last"] = rec["bytes_in_use"]
        if isinstance(rec.get("bytes_limit"), (int, float)):
            out["bytes_limit"] = rec["bytes_limit"]
        if isinstance(rec.get("peak_bytes_in_use"), (int, float)):
            out["peak_bytes_in_use"] = max(
                out["peak_bytes_in_use"] or 0, rec["peak_bytes_in_use"])
        if isinstance(rec.get("headroom_frac"), (int, float)):
            out["headroom_frac_max"] = max(
                out["headroom_frac_max"] or 0.0, rec["headroom_frac"])
        if isinstance(rec.get("recompile_count"), (int, float)):
            out["recompile_count"] = max(out["recompile_count"],
                                         int(rec["recompile_count"]))
    return out


def format_mem(name: str, summary: dict, compile_summary: dict) -> str:
    chunks = [f"mem: {name}"]
    n = summary["samples"]
    if n:
        grew = None
        if (summary["live_bytes_first"] is not None
                and summary["live_bytes_last"] is not None):
            grew = summary["live_bytes_last"] - summary["live_bytes_first"]
        chunks.append(
            f"live: {n} sample(s) over steps "
            f"[{_opt(summary['first_step'])}, {_opt(summary['last_step'])}]"
            f"  bytes {_opt(summary['live_bytes_first'])} -> "
            f"{_opt(summary['live_bytes_last'])}"
            + ("" if grew is None else f" (delta {_fmt(grew)})")
            + ("" if summary["live_count_last"] is None
               else f"  count={_fmt(summary['live_count_last'])}"))
        if summary["by_dtype"]:
            rows = [[dtype, _fmt(b)] for dtype, b in
                    sorted(summary["by_dtype"].items(),
                           key=lambda kv: -kv[1])]
            chunks.append("\n[footprint by dtype] (last sample)")
            chunks.append(_table(rows, ["dtype", "live_bytes"]))
        if summary["bytes_in_use_last"] is not None:
            chunks.append(
                f"\ndevice: reserved={_fmt(summary['bytes_in_use_last'])}"
                f" peak allocated={_opt(summary['peak_bytes_in_use'])}"
                f" limit={_opt(summary['bytes_limit'])}"
                f" headroom_frac_max={_opt(summary['headroom_frac_max'])}")
        else:
            chunks.append("\ndevice: no allocator statistics (the CPU; "
                          "live tensors only)")
    else:
        chunks.append("no mem records (run without --obs-mem)")
    shapes = compile_summary["shapes"]
    if shapes:
        rows = []
        for s in shapes:
            rows.append(["-" if s.get("shape_index") is None
                         else str(s["shape_index"]),
                         _opt(s.get("step")), _opt(s.get("peak_hbm_bytes")),
                         _opt(s.get("compile_s"))])
        chunks.append(f"\n[compile] ({len(shapes)} dispatch shape(s), "
                      f"recompile_count="
                      f"{compile_summary['recompile_count']})")
        chunks.append(_table(rows, ["idx", "step", "peak_alloc",
                                    "compile_s"]))
    rules = summary["rules"]
    if rules:
        chunks.append("\nmem-plane anomalies: " + "  ".join(
            f"{rule}={cnt}" for rule, cnt in sorted(rules.items())))
    elif n or shapes:
        chunks.append("\nmem-plane anomalies: none "
                      f"({', '.join(_MEM_RULES)} all quiet)")
    return "\n".join(chunks)


def run_mem(run: str, json_out: Optional[str] = None) -> int:
    """``mem`` subcommand: one run's live-memory windows, the first step
    of each dispatch shape, and the leak/headroom/storm rule summary."""
    try:
        records, bad = load_records(run)
    except OSError as e:
        print(f"cannot read {run}: {e}")
        return 2
    if bad:
        print(f"note: {run}: skipped {bad} malformed line(s)")
    summary = summarize_mem(records)
    comp = summarize_compile(records)
    name = os.path.basename(os.path.normpath(run)) or run
    print(format_mem(name, summary, comp))
    if json_out:
        with open(json_out, "w") as fh:
            json.dump({"mem": summary, "compile": comp}, fh, indent=1,
                      sort_keys=True)
            fh.write("\n")
        print(f"wrote {json_out}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "gate":
        gargs = build_gate_argparser().parse_args(argv[1:])
        return run_gate(gargs.run, gargs.baseline, gargs.write)
    if argv and argv[0] == "attr":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report attr",
            description="Print the paper's T_compute/T_select/T_comm "
                        "decomposition from a run's attr records or "
                        "straight from a torch.profiler trace.")
        ap.add_argument("target",
                        help="an --out-dir / metrics.jsonl with attr "
                             "records, or a profiler trace dir/file")
        ap.add_argument("--mode", default=None,
                        help="mode label stamped on a trace-derived record")
        ap.add_argument("--json", dest="json_out", default=None)
        a = ap.parse_args(argv[1:])
        return run_attr(a.target, mode=a.mode, json_out=a.json_out)
    if argv and argv[0] == "events":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report events",
            description="Summarize a run's anomaly event stream per rule "
                        "(first/last step, count, last value).")
        ap.add_argument("run")
        ap.add_argument("--json", dest="json_out", default=None)
        a = ap.parse_args(argv[1:])
        return run_events(a.run, json_out=a.json_out)
    if argv and argv[0] == "recovery":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report recovery",
            description="Summarize a run's resilience records: injected "
                        "faults, recovery actions, claimed vs unclaimed "
                        "anomaly events, final status.")
        ap.add_argument("run")
        ap.add_argument("--json", dest="json_out", default=None)
        a = ap.parse_args(argv[1:])
        return run_recovery(a.run, json_out=a.json_out)
    if argv and argv[0] == "timeline":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report timeline",
            description="Rebuild and validate a chrome-trace timeline "
                        "from a run's metrics.jsonl.")
        ap.add_argument("run")
        ap.add_argument("--out", default=None,
                        help="output path (default: <run>/timeline.json)")
        a = ap.parse_args(argv[1:])
        return run_timeline(a.run, out=a.out)
    if argv and argv[0] == "fleet":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report fleet",
            description="Merge per-rank metric shards into per-step "
                        "cross-rank stats (min/median/max/std + skew) "
                        "with slowest-rank straggler attribution.")
        ap.add_argument("targets", nargs="+",
                        help="run dirs holding metrics.rank*.jsonl (or "
                             "metrics.jsonl), or shard paths")
        ap.add_argument("--kinds", default=None,
                        help="comma-separated source kinds to merge "
                             "(default: obs,train,spans)")
        ap.add_argument("--json", dest="json_out", default=None)
        ap.add_argument("--allow-mismatch", action="store_true",
                        help="merge shards even when their manifest "
                             "config_hash differs (normally refused)")
        a = ap.parse_args(argv[1:])
        kinds = ([k.strip() for k in a.kinds.split(",") if k.strip()]
                 if a.kinds else None)
        return run_fleet(a.targets, kinds, json_out=a.json_out,
                         allow_mismatch=a.allow_mismatch)
    if argv and argv[0] == "critpath":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report critpath",
            description="Join per-rank critpath stage-interval records "
                        "into the global per-step critical path: which "
                        "(rank, stage) bounds each step, per-rank "
                        "stage/wait budgets, modal-path summary.")
        ap.add_argument("targets", nargs="+",
                        help="run dirs holding metrics.rank*.jsonl (or "
                             "metrics.jsonl), or shard paths")
        ap.add_argument("--json", dest="json_out", default=None)
        ap.add_argument("--allow-mismatch", action="store_true",
                        help="merge shards even when their manifest "
                             "config_hash differs (normally refused)")
        ap.add_argument("--halt-on", default=None,
                        choices=("warn", "error"),
                        help="exit HALT_EXIT_CODE when the "
                             "critpath_shift rule fires at (or above) "
                             "this severity, like --obs-halt-on")
        a = ap.parse_args(argv[1:])
        return run_critpath(a.targets, json_out=a.json_out,
                            allow_mismatch=a.allow_mismatch,
                            halt_on=a.halt_on)
    if argv and argv[0] == "goodput":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report goodput",
            description="Per-rank goodput/badput decomposition: what "
                        "fraction of each rank's wall-clock advanced "
                        "training, where the rest went (select/comm/"
                        "wait/compile/ckpt/wasted/degraded/data/"
                        "startup/other), and the whole-fleet roll-up.")
        ap.add_argument("targets", nargs="+",
                        help="run dirs holding metrics.rank*.jsonl (or "
                             "metrics.jsonl), or shard paths")
        ap.add_argument("--compare", default=None,
                        help="second run to diff fleet decompositions "
                             "against (chaos vs clean)")
        ap.add_argument("--advise", action="store_true",
                        help="print the eviction hint: the rank whose "
                             "badput drags furthest below the fleet "
                             "median goodput_frac, and the recoverable "
                             "rank-seconds")
        ap.add_argument("--json", dest="json_out", default=None)
        ap.add_argument("--allow-mismatch", action="store_true",
                        help="merge shards even when their manifest "
                             "config_hash differs (normally refused)")
        a = ap.parse_args(argv[1:])
        return run_goodput(a.targets, json_out=a.json_out,
                           allow_mismatch=a.allow_mismatch,
                           advise=a.advise, compare=a.compare)
    if argv and argv[0] == "watch":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report watch",
            description="Tail-follow live shards with a refreshing "
                        "per-rank summary (Ctrl-C to stop).")
        ap.add_argument("targets", nargs="+",
                        help="run dirs or shard paths to follow")
        ap.add_argument("--interval", type=float, default=2.0,
                        help="seconds between polls (default 2)")
        ap.add_argument("--iterations", type=int, default=None,
                        help="stop after N polls (default: forever)")
        a = ap.parse_args(argv[1:])
        return run_watch(a.targets, interval=a.interval,
                         iterations=a.iterations)
    if argv and argv[0] == "plan":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report plan",
            description="Print the comm-planner decision: chosen wire "
                        "plan, every candidate's modeled score, and the "
                        "alpha-beta inputs (parallel/planner.py).")
        ap.add_argument("run", help="run dir or record file")
        ap.add_argument("--json", dest="json_out", default=None)
        a = ap.parse_args(argv[1:])
        return run_plan(a.run, json_out=a.json_out)
    if argv and argv[0] == "compile":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report compile",
            description="Print the first step of each dispatch shape "
                        "(seconds, FLOPs, the allocator's peak) and the "
                        "recompile-watch events (obs/memwatch.py).")
        ap.add_argument("run", help="run dir or record file")
        ap.add_argument("--json", dest="json_out", default=None)
        a = ap.parse_args(argv[1:])
        return run_compile(a.run, json_out=a.json_out)
    if argv and argv[0] == "mem":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report mem",
            description="Print a run's live-memory windows (the CUDA "
                        "caching allocator's live, peak and reserved "
                        "bytes; on the CPU the live tensors by dtype), "
                        "the first step of each dispatch shape, and the "
                        "leak/headroom/storm anomaly summary.")
        ap.add_argument("run", help="run dir or record file")
        ap.add_argument("--json", dest="json_out", default=None)
        a = ap.parse_args(argv[1:])
        return run_mem(a.run, json_out=a.json_out)
    if argv and argv[0] == "ledger":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report ledger",
            description="Join measured per-step comm (attr t_comm_us, "
                        "obs wire_bytes) against the alpha-beta scaling "
                        "model; ratios ~1 mean the model explains the "
                        "wire.")
        ap.add_argument("targets", nargs="+",
                        help="run dirs or record files (fleet dirs ok)")
        ap.add_argument("--alpha-ms", type=float, default=None,
                        help="per-message latency override (default: the "
                             "fit's)")
        ap.add_argument("--beta-gbps", type=float, default=None,
                        help="link bandwidth override (default: the fit's)")
        ap.add_argument("--probe-dir", default=None,
                        help="a dir holding calib_fit_{P}proc.json (an out "
                             "dir of a --obs-calib run); default: the fit "
                             "committed for the run's backend "
                             "(parallel/comm_fit*.json)")
        ap.add_argument("--json", dest="json_out", default=None)
        a = ap.parse_args(argv[1:])
        return run_ledger(a.targets, json_out=a.json_out,
                          alpha_ms=a.alpha_ms, beta_gbps=a.beta_gbps,
                          probe_dir=a.probe_dir)
    if argv and argv[0] == "linkmap":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report linkmap",
            description="Join per-rank linkmap records into the fleet "
                        "network weather map: per-(axis, peer) EWMA "
                        "latency/bandwidth, worst link vs fleet median, "
                        "per-axis calib fits (obs/linkmap.py).")
        ap.add_argument("targets", nargs="+",
                        help="run dirs or record files (fleet dirs ok)")
        ap.add_argument("--json", dest="json_out", default=None)
        a = ap.parse_args(argv[1:])
        return run_linkmap(a.targets, json_out=a.json_out)
    if argv and argv[0] == "forecast":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report forecast",
            description="Scale-out forecast view (obs/forecast.py): "
                        "hindcast error vs the run's own measured step "
                        "time, the per-P recommendation grid with "
                        "uncertainty bands, and the tree->balanced "
                        "crossover P.")
        ap.add_argument("targets", nargs="+",
                        help="run dirs or record files (fleet dirs ok)")
        ap.add_argument("--targets-p", dest="forecast_targets",
                        default=None, metavar="LIST",
                        help="comma-separated modeled worker counts "
                             "(default 32,256,1024, or the run's own "
                             "forecast records)")
        ap.add_argument("--probe-dir", default=None,
                        help="a dir holding calib_fit_{P}proc.json, read "
                             "when the stream has no calib records; "
                             "default: the fit committed for the run's "
                             "backend (parallel/comm_fit*.json)")
        ap.add_argument("--json", dest="json_out", default=None)
        a = ap.parse_args(argv[1:])
        return run_forecast(a.targets, json_out=a.json_out,
                            search_dir=a.probe_dir,
                            forecast_targets=a.forecast_targets)
    if argv and argv[0] == "history":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report history",
            description="Cross-run trend table from a workspace registry "
                        "(runs.jsonl appended by --registry; "
                        "obs/registry.py).")
        ap.add_argument("registry", help="registry dir holding runs.jsonl")
        ap.add_argument("--config-hash", default=None,
                        help="only entries of this manifest config_hash")
        ap.add_argument("--json", dest="json_out", default=None)
        a = ap.parse_args(argv[1:])
        return run_history(a.registry, config_hash=a.config_hash,
                           json_out=a.json_out)
    if argv and argv[0] == "regress":
        ap = argparse.ArgumentParser(
            "gtopkssgd_tpu_torch.obs.report regress",
            description="Gate the run under test against the most recent "
                        "same-config registry entry with per-field rtol "
                        "drift checks; exit 0 pass / 1 regression / 2 "
                        "usage, like 'gate'.")
        ap.add_argument("run", help="an --out-dir or metrics.jsonl path")
        ap.add_argument("--registry", required=True,
                        help="registry dir holding runs.jsonl")
        ap.add_argument("--allow-mismatch", action="store_true",
                        help="fall back to the newest entry of ANY "
                             "config_hash when none matches (normally "
                             "refused: cross-config comparison)")
        ap.add_argument("--json", dest="json_out", default=None)
        a = ap.parse_args(argv[1:])
        return run_regress(a.run, a.registry,
                           allow_mismatch=a.allow_mismatch,
                           json_out=a.json_out)
    args = build_argparser().parse_args(argv)
    if len(args.runs) > 2:
        print("at most 2 runs (one to summarize, two to compare)")
        return 2
    kinds = ([k.strip() for k in args.kinds.split(",") if k.strip()]
             if args.kinds else None)
    summaries, names, all_records = [], [], []
    for run in args.runs:
        try:
            records, bad = load_records(run)
        except OSError as e:
            print(f"cannot read {run}: {e}")
            return 2
        names.append(os.path.basename(os.path.normpath(run)) or run)
        summaries.append(summarize(records))
        all_records.append(records)
        if bad:
            print(f"note: {run}: skipped {bad} malformed line(s)")
        unknown = unregistered_kinds(records)
        if unknown:
            print(f"note: {run}: unregistered kind(s) "
                  f"{', '.join(unknown)} (not in utils.metrics.KINDS)")
    if len(summaries) == 1:
        manifest = extract_manifest(all_records[0])
        layers = summarize_layers(all_records[0])
        payload = {"run": names[0], "summary": summaries[0],
                   "manifest": manifest, "layers": layers}
        print(format_summary(names[0], summaries[0], kinds))
        if manifest and (not kinds or "manifest" in kinds):
            print()
            print(format_manifest(manifest))
        if layers and (not kinds or "layers" in kinds):
            print()
            print(format_layers(layers))
    else:
        diff = compare(summaries[0], summaries[1])
        payload = {
            "run_a": names[0], "run_b": names[1],
            "summary_a": summaries[0], "summary_b": summaries[1],
            "diff": diff,
        }
        print(format_compare(names[0], names[1], diff, kinds))
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
        print(f"\nwrote {args.json_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
