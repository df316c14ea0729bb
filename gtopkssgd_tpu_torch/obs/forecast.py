"""The scale-out forecast, the port of ``gtopkssgd_tpu/obs/forecast.py``:
the run's own measurements priced at fleet sizes it did not run.

The **hindcast** comes first: this run's step time predicted from its
comm fit, its measured compute and select budgets (``obs.critpath``) and
its link weather (``obs.linkmap``: links priced at their measured
multiple of the median), against the step time the critpath records
measured. The symmetric error ``max(pred/meas, meas/pred)`` goes into a
durable "forecast" record (fsynced before the ``forecast_drift`` rule
sees it, so a halt never loses the record behind it).

The **forecast** then prices a grid of (P target, wire schedule, axis
tree) with the one pricing function of the port, ``parallel.comm_model.
predict_comm_ms`` through ``obs.ledger`` (the planner's, the bucket
DP's, critpath's and the ledger's), composing each cell's step time and
goodput share from the measured budgets. A band of messages x
``resid_ms`` (the calibrator's per-message residual) brackets each cell;
a fit without a residual gets no band. Per P target the cheapest cell is
the recommendation, an exact string such as "tree@flat" that the
registry's ``regress`` pins, and ``crossover_p`` is the smallest power of
two from which the balanced schedule stays cheaper than the tree.

No link constant is made up. The fit is, in order: the calibrator's live
refit (``note_calib``), the inputs that priced the run's plan (the fit
committed for the backend, ``comm_model.COMMITTED_FITS``, or
``--comm-model-fit``), or offline ``obs.ledger.load_alpha_beta`` (a
``calib_fit_{P}proc.json``, else the committed fit). A fit without
``ici_gbps`` prices the in-slice hop at its own beta, as ``obs.ledger``
does: one link class is measured on cards. Where no fit is found nothing
is forecast (no record, an empty summary that says why).

The modeled axis trees keep the JAX package's names and sizes
(``AXIS_TREES``): topologies to price, not measurements. With one link
class measured, "pod" differs from "flat" only in the messages that pay
the fit's alpha (the in-slice hops carry none) until a second link class
is measured on cards.

Arithmetic on the host only; the live ``StepForecaster`` rides the
calibrator's captures (``--obs-forecast`` in the trainer), and
``summarize_forecast`` rebuilds the same view from any record stream.
"""

from __future__ import annotations

from typing import (Any, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

from gtopkssgd_tpu_torch.obs.calib import _finite, _ratio_x, message_count
from gtopkssgd_tpu_torch.obs.ledger import (
    _manifest_params,
    load_alpha_beta,
    predict_comm_ms,
    wire_mode_for,
)

# Modeled worker counts (the JAX package's targets): one pod
# row, one multi-pod row, one "would the paper's regime hold" row.
DEFAULT_TARGETS = (32, 256, 1024)

# Modeled axis trees as (name, ici_size), the JAX package's: "flat"
# prices every hop on the fitted link (what a multi-process run
# measures); "pod" slices of 16 ranks whose in-slice hops pay no alpha
# (at the fit's own beta while one link class is measured). The grid is
# open: callers can pass any (name, ici_size) list.
AXIS_TREES = (("flat", 1), ("pod", 16))

# Wire schedules the planner chooses between (parallel/planner.py
# candidate_plans): the O(k log P) hypercube tree vs Ok-Topk's O(k)
# balanced split-and-reduce.
SCHEDULES = ("tree", "balanced")

# EWMA smoothing for the live budgets — matches linkmap's default.
_EWMA_ALPHA = 0.3

_EPS = 1e-9


def plan_key(schedule: str, tree: str) -> str:
    """The exact recommendation string the registry regress-pins,
    e.g. "tree@pod" / "balanced@flat"."""
    return f"{schedule}@{tree}"


def degrade_factor(links: Any) -> float:
    """Fleet degradation multiplier from per-link EWMA latencies:
    sum(link prices) / (n x fleet median) — i.e. every link priced at
    its MEASURED multiple of the median instead of flattening the fleet
    to one homogeneous link. 1.0 for an empty/homogeneous map; a fleet
    with one 4x link among eight reads ~1.4x, which is exactly the
    factor a schedule touching every link pays. Accepts a {key: ewma_ms}
    mapping, a linkmap record's ``links`` list, or a bare sequence of
    latencies."""
    if isinstance(links, Mapping):
        vals = [float(v) for v in links.values()
                if isinstance(v, (int, float)) and not isinstance(v, bool)]
    else:
        vals = []
        for item in links or ():
            if isinstance(item, Mapping):
                item = item.get("ewma_ms")
            if isinstance(item, (int, float)) and not isinstance(item, bool):
                vals.append(float(item))
    if not vals:
        return 1.0
    s = sorted(vals)
    mid = len(s) // 2
    med = s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])
    if med <= _EPS:
        return 1.0
    return (sum(vals) / len(vals)) / med


def _clean_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Normalize a ledger ``_manifest_params``-shaped dict (or a hand
    dict) into the keys the grid needs."""
    return {
        "mode": str(params.get("mode") or "gtopk"),
        "n": int(params["n"]),
        "k": int(params.get("k") or params["n"]),
        "codec": str(params.get("codec") or "fp32"),
        "bucketing": str(params.get("bucketing") or "concat"),
        "buckets": params.get("buckets"),
    }


def usable_fit(fit: Optional[Mapping[str, Any]]) -> bool:
    """Whether `fit` can price a cell: a finite beta_gbps > 0 (alpha may
    be 0, a fit's own finding)."""
    return (fit is not None and _finite(fit.get("beta_gbps"))
            and fit["beta_gbps"] > 0)


def _link(fit: Mapping[str, Any]) -> Dict[str, float]:
    """The model's constants of `fit`: its alpha (0 when it has none),
    its beta, and its ici_gbps or, without one, its beta."""
    beta = float(fit["beta_gbps"])
    ici = fit.get("ici_gbps")
    return {"alpha_ms": float(fit.get("alpha_ms") or 0.0),
            "beta_gbps": beta,
            "ici_gbps": float(ici) if _finite(ici) and ici > 0 else beta}


def _cell_comm_ms(params: Mapping[str, Any], fit: Mapping[str, Any],
                  p: int, schedule: str, ici_size: int
                  ) -> Tuple[str, float]:
    """(wire_mode, modeled comm_ms) of one grid cell: the planner's
    ``predict_comm_ms`` at the target's P and topology."""
    wm = wire_mode_for(params["mode"], schedule, params.get("bucketing"))
    comm = predict_comm_ms(
        wm, int(p), n=params["n"], k=params["k"], **_link(fit),
        ici_size=max(1, int(ici_size)), codec=params["codec"],
        buckets=params.get("buckets"))
    return wm, comm


def grid_rows(params: Mapping[str, Any], fit: Mapping[str, Any], *,
              compute_ms: float, select_ms: float = 0.0,
              degrade_x: float = 1.0,
              targets: Sequence[int] = DEFAULT_TARGETS,
              trees: Sequence[Tuple[str, int]] = AXIS_TREES
              ) -> List[dict]:
    """The forecast grid: one row per (P target, schedule, axis tree).

    step_ms = compute + select + comm x degrade_x, with comm priced by
    the run's own fitted alpha/beta at the cell's topology. The
    uncertainty band is messages x resid_ms (the Theil-Sen noise floor
    per slow-link message) — absent resid_ms (probe-era artifacts) the
    band is 0 rather than invented. goodput_frac is the predicted
    productive fraction compute/step — select and comm are badput under
    the goodput taxonomy, and nothing is clamped: a comm-dominated cell
    honestly reads a tiny fraction. Cells whose (wire_mode, ici_size)
    duplicate an earlier schedule at the same P (dense runs, where
    "balanced" maps back to the same wire) are skipped."""
    params = _clean_params(params)
    resid = fit.get("resid_ms")
    resid = (float(resid)
             if isinstance(resid, (int, float)) and resid > 0 else 0.0)
    rows: List[dict] = []
    for p in targets:
        p = int(p)
        seen: set = set()
        for schedule in SCHEDULES:
            for tree, ici_size in trees:
                wm, comm = _cell_comm_ms(params, fit, p, schedule,
                                         ici_size)
                if (wm, ici_size) in seen:
                    continue
                seen.add((wm, ici_size))
                comm_deg = comm * max(0.0, float(degrade_x))
                step_ms = float(compute_ms) + float(select_ms) + comm_deg
                msgs = message_count(wm, p, ici_size=max(1, int(ici_size)))
                band = msgs * resid
                rows.append({
                    "p": p, "schedule": schedule, "tree": tree,
                    "plan": plan_key(schedule, tree),
                    "ici_size": int(ici_size), "wire_mode": wm,
                    "msgs": msgs,
                    "comm_ms": round(comm, 6),
                    "comm_degraded_ms": round(comm_deg, 6),
                    "step_ms": round(step_ms, 6),
                    "band_ms": round(band, 6),
                    "step_ms_lo": round(step_ms - band, 6),
                    "step_ms_hi": round(step_ms + band, 6),
                    "goodput_frac": (round(float(compute_ms) / step_ms, 6)
                                     if step_ms > 0 else None),
                })
    return rows


def recommend(rows: Iterable[Mapping[str, Any]]) -> Dict[int, dict]:
    """{P: cheapest row} by mid-band step_ms; ties break toward the
    lexicographically first plan key so the pick — and therefore the
    regress-pinned string — is deterministic."""
    best: Dict[int, dict] = {}
    for row in sorted(rows, key=lambda r: (str(r.get("plan")))):
        p = int(row["p"])
        cur = best.get(p)
        if cur is None or row["step_ms"] < cur["step_ms"]:
            best[p] = dict(row)
    return best


def crossover_p(params: Mapping[str, Any], fit: Mapping[str, Any], *,
                compute_ms: float = 0.0, select_ms: float = 0.0,
                degrade_x: float = 1.0, p_max: int = 1024,
                trees: Sequence[Tuple[str, int]] = AXIS_TREES
                ) -> Optional[int]:
    """Smallest power-of-two P (2..p_max) from which the balanced
    schedule's best tree beats the hypercube tree's AT EVERY LARGER
    scanned P too — the O(k) vs O(k log P) crossover the paper's
    scaling argument turns on, required to be sustained (a pod-sized
    fleet where every balanced hop is free ICI can win a single small-P
    cell without the regime actually flipping). None when the tree
    holds at scale (latency-priced fabrics: the balanced schedule's
    O(P) messages each pay alpha)."""
    params = _clean_params(params)
    balanced_wins: List[Tuple[int, bool]] = []
    p = 2
    while p <= max(2, int(p_max)):
        by_schedule: Dict[str, float] = {}
        for schedule in SCHEDULES:
            best = None
            for _, ici_size in trees:
                _, comm = _cell_comm_ms(params, fit, p, schedule,
                                        ici_size)
                if best is None or comm < best:
                    best = comm
            by_schedule[schedule] = (float(compute_ms) + float(select_ms)
                                     + best * max(0.0, float(degrade_x)))
        balanced_wins.append(
            (p, by_schedule["balanced"] < by_schedule["tree"]))
        p *= 2
    cross: Optional[int] = None
    for p, wins in balanced_wins:
        if wins:
            if cross is None:
                cross = p
        else:
            cross = None
    return cross


def hindcast(critpath_records: Iterable[Mapping[str, Any]],
             comm_model_ms: float, *, degrade_x: float = 1.0,
             spd: int = 1) -> Optional[dict]:
    """Predicted vs measured step time over a run's own critpath
    records — the model's validation against the reality it was fitted
    on.

    Per capture (spanning ``spd`` optimizer steps), predicted =
    measured compute + select stage budgets + spd x modeled comm x
    degrade_x; measured = the record's wall. The comm + wait the model
    must explain is exactly what the prediction replaces — wait is a
    skew symptom the degrade factor prices, not a budget to copy
    through. Returns {n, pred_ms, meas_ms, err_x} with err the
    symmetric factor max(pred/meas, meas/pred) over the means, or None
    with no usable records."""
    preds: List[float] = []
    meas: List[float] = []
    spd = max(1, int(spd))
    for rec in critpath_records:
        wall = rec.get("wall_us")
        comp = rec.get("t_compute_us")
        if not isinstance(wall, (int, float)) or wall <= 0 \
                or not isinstance(comp, (int, float)):
            continue
        sel = rec.get("t_select_us")
        sel = float(sel) if isinstance(sel, (int, float)) else 0.0
        pred_us = (float(comp) + sel
                   + spd * float(comm_model_ms) * 1e3
                   * max(0.0, float(degrade_x)))
        preds.append(pred_us / 1e3 / spd)
        meas.append(float(wall) / 1e3 / spd)
    if not preds:
        return None
    pred_ms = sum(preds) / len(preds)
    meas_ms = sum(meas) / len(meas)
    return {
        "n": len(preds),
        "pred_ms": round(pred_ms, 6),
        "meas_ms": round(meas_ms, 6),
        "err_x": round(_ratio_x(pred_ms, meas_ms) or 1.0, 6),
    }


def _flat_record(hc: Mapping[str, Any], rows: Sequence[dict],
                 recs: Mapping[int, dict], fit: Mapping[str, Any], *,
                 compute_ms: float, select_ms: float,
                 comm_model_ms: float, degrade_x: float,
                 cross_p: Optional[int]) -> Dict[str, Any]:
    """The durable ``forecast`` record body: flat per-P fields (so the
    generic exporter maps them straight onto gtopk_forecast_* gauges
    and the registry regress-pins the rec_p* strings) plus the full
    grid under ``rows`` for offline readers."""
    rec: Dict[str, Any] = {
        "hindcast_err_x": hc["err_x"],
        "hindcast_pred_ms": hc["pred_ms"],
        "hindcast_meas_ms": hc["meas_ms"],
        "n_hindcast": hc["n"],
        "compute_ms": round(float(compute_ms), 6),
        "select_ms": round(float(select_ms), 6),
        "comm_model_ms": round(float(comm_model_ms), 6),
        "degrade_x": round(float(degrade_x), 6),
        "alpha_ms": round(float(fit.get("alpha_ms") or 0.0), 6),
        "beta_gbps": round(float(fit["beta_gbps"]), 6),
    }
    resid = fit.get("resid_ms")
    if isinstance(resid, (int, float)) and resid > 0:
        rec["resid_ms"] = round(float(resid), 6)
    if fit.get("fit_source"):
        rec["fit_source"] = str(fit["fit_source"])
    if cross_p is not None:
        rec["crossover_p"] = int(cross_p)
    for p, row in sorted(recs.items()):
        rec[f"rec_p{p}"] = row["plan"]
        rec[f"step_ms_p{p}"] = row["step_ms"]
        rec[f"step_ms_lo_p{p}"] = row["step_ms_lo"]
        rec[f"step_ms_hi_p{p}"] = row["step_ms_hi"]
        if row.get("goodput_frac") is not None:
            rec[f"goodput_frac_p{p}"] = row["goodput_frac"]
    rec["rows"] = list(rows)
    return rec


class StepForecaster:
    """The live forecaster: rides the calibrator's capture cadence.

    Fed the SAME surfaces the trainer already produces — each capture's
    critpath record (stage budgets + measured wall), each calib refit
    (live alpha/beta/resid), each linkmap snapshot (link weather) —
    and, once per capture, composes them into one durable ``forecast``
    record: the hindcast error against this run plus the per-P-target
    grid. The record is written flush=True BEFORE the monitor's
    ``forecast_drift`` rule observes the error, so a drift halt can
    never lose the evidence that triggered it (the linkmap/goodput
    durable-before-halt contract).

    ``params`` is a ledger ``_manifest_params``-shaped dict (the run's
    mode/n/k/codec/schedule/bucketing/buckets); ``baseline`` the
    planner's inputs ({alpha_ms, beta_gbps, ici_gbps, fit_source}) the
    fit starts from until the first calib refit arrives. Without a
    usable fit (``usable_fit``) ``observe`` writes nothing."""

    def __init__(self, params: Mapping[str, Any], *,
                 baseline: Optional[Mapping[str, Any]] = None,
                 targets: Sequence[int] = DEFAULT_TARGETS,
                 trees: Sequence[Tuple[str, int]] = AXIS_TREES,
                 metrics=None, monitor=None,
                 ewma_alpha: float = _EWMA_ALPHA):
        self.params = dict(params)
        self.p = max(1, int(params.get("p") or 1))
        self.schedule = params.get("schedule")
        self.targets = tuple(int(t) for t in targets)
        self.trees = tuple((str(nm), int(sz)) for nm, sz in trees)
        self.metrics = metrics
        self.monitor = monitor
        self.ewma_alpha = float(ewma_alpha)
        base = dict(baseline) if baseline else {}
        self.fit: Dict[str, Any] = {
            "alpha_ms": base.get("alpha_ms"),
            "beta_gbps": base.get("beta_gbps"),
            "ici_gbps": base.get("ici_gbps"),
            "resid_ms": base.get("resid_ms"),
            "fit_source": base.get("fit_source"),
        }
        # Per-step EWMA budgets from critpath captures; None until the
        # first capture (the first sample SEEDS the EWMA rather than
        # being smoothed toward an invented zero) — observe() has
        # nothing honest to say before.
        self.compute_ms: Optional[float] = None
        self.select_ms: Optional[float] = None
        self.meas_ms: Optional[float] = None
        self.degrade_x: float = 1.0
        self.n_obs = 0
        self.records: List[dict] = []

    # ------------------------------------------------------------ feeds
    def _ewma(self, cur: Optional[float], new: float) -> float:
        if cur is None:
            return new
        return cur + self.ewma_alpha * (new - cur)

    def note_critpath(self, cp: Mapping[str, Any], spd: int = 1) -> None:
        """Fold one critpath record's stage budgets (per optimizer
        step) into the EWMA state; ``spd`` is the steps the capture
        spanned."""
        spd = max(1, int(spd))
        wall = cp.get("wall_us")
        comp = cp.get("t_compute_us")
        if not isinstance(wall, (int, float)) or wall <= 0 \
                or not isinstance(comp, (int, float)):
            return
        sel = cp.get("t_select_us")
        sel = float(sel) if isinstance(sel, (int, float)) else 0.0
        self.compute_ms = self._ewma(self.compute_ms,
                                     float(comp) / 1e3 / spd)
        self.select_ms = self._ewma(self.select_ms, sel / 1e3 / spd)
        self.meas_ms = self._ewma(self.meas_ms, float(wall) / 1e3 / spd)

    def note_calib(self, rec: Mapping[str, Any]) -> None:
        """Adopt a calib refit's live fit (alpha_fit_ms/beta_fit_gbps,
        plus its resid_ms noise floor) — the forecast reprices itself
        from measured reality the moment the calibrator does."""
        a, b = rec.get("alpha_fit_ms"), rec.get("beta_fit_gbps")
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                and b > 0:
            self.fit["alpha_ms"] = float(a)
            self.fit["beta_gbps"] = float(b)
            self.fit["fit_source"] = "calib"
        r = rec.get("resid_ms")
        if isinstance(r, (int, float)) and r >= 0:
            self.fit["resid_ms"] = float(r)

    def note_linkmap(self, rec: Mapping[str, Any]) -> None:
        """Update the degradation multiplier from a weather-map
        snapshot: links priced at their measured multiple of the
        median."""
        links = rec.get("links")
        if links:
            self.degrade_x = degrade_factor(links)

    # ---------------------------------------------------------- observe
    def observe(self, step: int) -> Optional[dict]:
        """One capture -> durable ``forecast`` record, then the
        ``forecast_drift`` rule. None until a critpath budget exists
        (no honest hindcast without a measured step), and None without
        a usable fit. May raise AnomalyHalt through the monitor — after
        the record is on disk."""
        if self.compute_ms is None or self.meas_ms is None:
            return None
        if not usable_fit(self.fit):
            return None
        wm = wire_mode_for(self.params.get("mode") or "gtopk",
                           self.schedule, self.params.get("bucketing"))
        fit = dict(_link(self.fit), resid_ms=self.fit.get("resid_ms"),
                   fit_source=self.fit.get("fit_source"))
        comm_model_ms = predict_comm_ms(
            wm, self.p, n=int(self.params["n"]),
            k=int(self.params.get("k") or self.params["n"]),
            alpha_ms=fit["alpha_ms"], beta_gbps=fit["beta_gbps"],
            ici_gbps=fit["ici_gbps"],
            ici_size=max(1, int(self.params.get("ici_size") or 1)),
            codec=str(self.params.get("codec") or "fp32"),
            buckets=self.params.get("buckets"))
        pred_ms = (self.compute_ms + self.select_ms
                   + comm_model_ms * self.degrade_x)
        hc = {
            "n": 1,
            "pred_ms": round(pred_ms, 6),
            "meas_ms": round(self.meas_ms, 6),
            "err_x": round(_ratio_x(pred_ms, self.meas_ms) or 1.0, 6),
        }
        rows = grid_rows(self.params, fit,
                         compute_ms=self.compute_ms,
                         select_ms=self.select_ms,
                         degrade_x=self.degrade_x,
                         targets=self.targets, trees=self.trees)
        recs = recommend(rows)
        cross = crossover_p(self.params, fit,
                            compute_ms=self.compute_ms,
                            select_ms=self.select_ms,
                            degrade_x=self.degrade_x,
                            p_max=max(self.targets) if self.targets
                            else 1024,
                            trees=self.trees)
        rec = _flat_record(hc, rows, recs, fit,
                           compute_ms=self.compute_ms,
                           select_ms=self.select_ms,
                           comm_model_ms=comm_model_ms,
                           degrade_x=self.degrade_x, cross_p=cross)
        rec["step"] = int(step)
        self.n_obs += 1
        rec["n_obs"] = self.n_obs
        self.records.append(rec)
        # Record FIRST (fsync'd), then the rule — a drift halt must not
        # lose the forecast that triggered it.
        if self.metrics is not None:
            self.metrics.log("forecast", flush=True, **rec)
        if self.monitor is not None:
            self.monitor.observe_forecast(int(step),
                                          err_x=hc["err_x"])
        return rec


# --------------------------------------------------------------- offline
def _last_of(records: Sequence[Mapping[str, Any]], kind: str
             ) -> Optional[dict]:
    out = None
    for rec in records:
        if rec.get("kind") == kind:
            out = rec
    return dict(out) if out is not None else None


def summarize_forecast(records: Iterable[Mapping[str, Any]], *,
                       search_dir: Optional[str] = None,
                       nprocs: Optional[int] = None,
                       targets: Optional[Sequence[int]] = None,
                       trees: Sequence[Tuple[str, int]] = AXIS_TREES,
                       spd: int = 1,
                       backend: Optional[str] = None) -> dict:
    """The ``report forecast`` view from any record stream.

    A run that shipped live ``forecast`` records is summarized from its
    LAST one (source "record" — what the run itself durably said).
    Otherwise the summary is rebuilt offline from the same evidence the
    live path composes: manifest params, the last calib refit (else
    ``load_alpha_beta(search_dir, nprocs, backend)``: a calib_fit, else
    the fit committed for `backend`, by default the manifest's), mean
    critpath budgets, and the last weather-map snapshot (source
    "stream"). Returns {"rows": [], "reason": ...} when the stream
    cannot parameterize the model or no fit is found — a report must
    say why it is empty, not guess."""
    records = [r for r in records if isinstance(r, Mapping)]
    targets = (tuple(int(t) for t in targets)
               if targets else DEFAULT_TARGETS)
    last = _last_of(records, "forecast")
    if last is not None:
        recs = {}
        for key, val in last.items():
            if key.startswith("rec_p") and key[5:].isdigit():
                recs[int(key[5:])] = {
                    "plan": str(val),
                    "step_ms": last.get(f"step_ms_p{key[5:]}"),
                    "step_ms_lo": last.get(f"step_ms_lo_p{key[5:]}"),
                    "step_ms_hi": last.get(f"step_ms_hi_p{key[5:]}"),
                    "goodput_frac": last.get(
                        f"goodput_frac_p{key[5:]}"),
                }
        return {
            "source": "record",
            "rows": list(last.get("rows") or ()),
            "recs": recs,
            "hindcast": {
                "n": last.get("n_hindcast"),
                "pred_ms": last.get("hindcast_pred_ms"),
                "meas_ms": last.get("hindcast_meas_ms"),
                "err_x": last.get("hindcast_err_x"),
            },
            "crossover_p": last.get("crossover_p"),
            "fit": {
                "alpha_ms": last.get("alpha_ms"),
                "beta_gbps": last.get("beta_gbps"),
                "resid_ms": last.get("resid_ms"),
                "fit_source": last.get("fit_source"),
            },
            "degrade_x": last.get("degrade_x"),
            "record": last,
        }
    manifest = _last_of(records, "manifest")
    params = _manifest_params(manifest)
    if params is None:
        return {"rows": [], "recs": {}, "hindcast": None,
                "reason": ("no forecast records and no manifest to "
                           "parameterize the model from")}
    # Fit: the run's own last refit wins; a fit file (calib_fit, else
    # the committed card fit) is the next-best measured truth; without
    # either nothing is priced.
    calib = _last_of(records, "calib")
    if (calib is not None and _finite(calib.get("alpha_fit_ms"))
            and usable_fit({"beta_gbps": calib.get("beta_fit_gbps")})):
        fit = {"alpha_ms": float(calib["alpha_fit_ms"]),
               "beta_gbps": float(calib["beta_fit_gbps"]),
               "resid_ms": calib.get("resid_ms"),
               "fit_source": "calib-record"}
    else:
        art = load_alpha_beta(
            search_dir=search_dir, nprocs=nprocs,
            backend=backend or (manifest or {}).get("backend") or "gloo")
        if art is None:
            return {"rows": [], "recs": {}, "hindcast": None,
                    "reason": ("no comm fit to price with (no calib "
                               "records, no calib_fit file, no committed "
                               "fit for the backend)")}
        fit = {"alpha_ms": art["alpha_ms"],
               "beta_gbps": art["beta_gbps"],
               "resid_ms": art.get("resid_ms"),
               "fit_source": art["source"]}
    lm = _last_of(records, "linkmap")
    degrade = degrade_factor(lm.get("links")) if lm else 1.0
    crit = [r for r in records if r.get("kind") == "critpath"]
    if not crit:
        return {"rows": [], "recs": {}, "hindcast": None, "fit": fit,
                "reason": ("no critpath records — the forecast needs "
                           "measured compute/select budgets (run with "
                           "--obs-critpath)")}
    spd = max(1, int(spd))
    comps = [float(r["t_compute_us"]) / 1e3 / spd for r in crit
             if isinstance(r.get("t_compute_us"), (int, float))]
    sels = [float(r["t_select_us"]) / 1e3 / spd for r in crit
            if isinstance(r.get("t_select_us"), (int, float))]
    compute_ms = sum(comps) / len(comps) if comps else 0.0
    select_ms = sum(sels) / len(sels) if sels else 0.0
    wm = wire_mode_for(params["mode"], params.get("schedule"),
                       params.get("bucketing"))
    comm_model_ms = predict_comm_ms(
        wm, params["p"], n=params["n"], k=params["k"], **_link(fit),
        codec=params["codec"], buckets=params.get("buckets"))
    hc = hindcast(crit, comm_model_ms, degrade_x=degrade, spd=spd)
    rows = grid_rows(params, fit, compute_ms=compute_ms,
                     select_ms=select_ms, degrade_x=degrade,
                     targets=targets, trees=trees)
    recs = recommend(rows)
    cross = crossover_p(params, fit, compute_ms=compute_ms,
                        select_ms=select_ms, degrade_x=degrade,
                        p_max=max(targets), trees=trees)
    return {
        "source": "stream",
        "rows": rows,
        "recs": recs,
        "hindcast": hc,
        "crossover_p": cross,
        "fit": fit,
        "degrade_x": round(degrade, 6),
        "comm_model_ms": round(comm_model_ms, 6),
        "compute_ms": round(compute_ms, 6),
        "select_ms": round(select_ms, 6),
    }


def format_forecast(summary: Mapping[str, Any]) -> str:
    """The ``report forecast`` text: hindcast line (the model's earned
    credibility), the per-P grid with uncertainty columns, the
    recommendation per target, and the tree->balanced crossover."""
    rows = summary.get("rows") or []
    if not rows:
        return ("forecast: " + str(summary.get(
            "reason", "no forecast evidence in this stream")))
    lines: List[str] = []
    fit = summary.get("fit") or {}
    src = fit.get("fit_source") or "?"
    lines.append(
        f"forecast: fit alpha_ms={fit.get('alpha_ms')} "
        f"beta_gbps={fit.get('beta_gbps')} "
        f"resid_ms={fit.get('resid_ms')} [{src}]  "
        f"(from {summary.get('source', '?')})")
    hc = summary.get("hindcast")
    if hc and isinstance(hc.get("err_x"), (int, float)):
        lines.append(
            f"hindcast: predicted {hc.get('pred_ms')} ms vs measured "
            f"{hc.get('meas_ms')} ms over n={hc.get('n')} capture(s) "
            f"-> err {float(hc['err_x']):.2f}x")
    dx = summary.get("degrade_x")
    if isinstance(dx, (int, float)) and abs(float(dx) - 1.0) > 1e-6:
        lines.append(f"link degradation multiplier: {float(dx):.3f}x "
                     "(links priced at their measured multiple)")
    header = ["p", "plan", "wire", "step_ms", "lo", "hi", "comm_ms",
              "goodput"]
    table: List[List[str]] = []
    for r in sorted(rows, key=lambda r: (int(r.get("p", 0)),
                                         str(r.get("plan")))):
        gp = r.get("goodput_frac")
        table.append([
            str(r.get("p")), str(r.get("plan")),
            str(r.get("wire_mode", "?")),
            f"{float(r.get('step_ms', 0.0)):.3f}",
            f"{float(r.get('step_ms_lo', 0.0)):.3f}",
            f"{float(r.get('step_ms_hi', 0.0)):.3f}",
            f"{float(r.get('comm_ms', 0.0)):.3f}",
            ("-" if not isinstance(gp, (int, float))
             else f"{float(gp):.3f}"),
        ])
    cols = [max(len(str(row[i])) for row in [header] + table)
            for i in range(len(header))]
    for row in [header, ["-" * w for w in cols]] + table:
        lines.append("  ".join(str(c).ljust(w)
                               for c, w in zip(row, cols)))
    recs = summary.get("recs") or {}
    for p in sorted(recs):
        r = recs[p]
        step = r.get("step_ms")
        lo, hi = r.get("step_ms_lo"), r.get("step_ms_hi")
        band = ""
        if isinstance(lo, (int, float)) and isinstance(hi, (int, float)):
            band = f" [{float(lo):.3f}, {float(hi):.3f}]"
        lines.append(f"recommendation P={p}: {r.get('plan')} "
                     f"(step {step} ms{band})")
    cross = summary.get("crossover_p")
    if cross is not None:
        lines.append(f"crossover: balanced overtakes tree at P={cross}")
    else:
        lines.append("crossover: none in range (tree holds — the "
                     "balanced schedule's O(P) messages each pay the "
                     "fitted alpha)")
    return "\n".join(lines)
