"""The online comm-model calibrator, the port of ``gtopkssgd_tpu/obs/
calib.py``: a live {alpha_ms, beta_gbps} from the run's own measured
(wire bytes, comm time) samples.

The planner (``parallel.planner``) and the bucket DP price with a fit
measured once (``comm_probe``, committed as ``parallel/comm_fit*.json``);
this module refits the same two constants on whatever link the run has.
One merge under a schedule launches ``msgs`` messages (the tree's
rounds, the balanced schedule's 2(p - 1) hops, ...), so

    t_ms / msgs  =  alpha_ms  +  (wire_bytes / msgs) * 8e-6 / beta_gbps

is one straight line whatever the schedule or the worker count. The fit
is Theil-Sen (median of pairwise slopes, the intercept from the median
residual), robust to straggler outliers; where the bytes barely vary the
slope is unidentifiable and the fit holds beta at the baseline
("alpha_only").

Each refit logs one ``"calib"`` record (fsynced), then feeds the anomaly
monitor's ``comm_model_drift`` rule with the fit against the planner's
inputs; at the end of the run ``write_artifact`` writes
``calib_fit_{P}proc.json`` into the out dir, with the card's name and
power limit in its provenance, which ``obs.ledger.load_alpha_beta`` reads
before the committed fits and ``--comm-model-fit`` takes as it is.

The trainer feeds it at P > 1 with the counters on: ``wire_bytes`` is
the counters' (``obs.counters``), the comm time the attributed comm of a
captured dispatch a step (``obs.trace_attr``; host time under gloo).
Samples of an overlapped pipeline are quarantined, never fitted.
"""

from __future__ import annotations

import json
import math
import os
import statistics
from typing import Any, Dict, List, Mapping, Optional, Tuple

from gtopkssgd_tpu_torch.obs import linkmap as _linkmap
from gtopkssgd_tpu_torch.parallel import comm_model
from gtopkssgd_tpu_torch.parallel.collectives import tree_rounds

# bytes -> ms conversion at 1 Gbps: t_ms = bytes * 8 / (beta_gbps * 1e9)
# * 1e3 = bytes * _MS_PER_BYTE_AT_1GBPS / beta_gbps.
_MS_PER_BYTE_AT_1GBPS = 8e-6

# Relative spread of bytes-per-message below which the slope (and so
# beta) is treated as unidentifiable and the fit degrades to alpha-only.
_MIN_X_SPREAD = 0.05

# Newest samples used per fit: Theil-Sen is O(n^2) pairs, and recent
# samples describe the fabric NOW (the whole point of live calibration).
_FIT_WINDOW = 256


def message_count(wire_mode: str, p: int, *, ici_size: int = 1) -> int:
    """Slow-link message launches of ONE merge under ``wire_mode`` — the
    alpha multiplier of exactly the decomposition ``predict_comm_ms``
    prices, so inverting it recovers the same constants the planner
    consumes. 0 at p<=1 (nothing on the wire to calibrate from)."""
    p = int(p)
    if p <= 1:
        return 0
    if wire_mode == "dense":
        return 2 * (p - 1)
    if wire_mode == "gtopk_balanced":
        return 2 * (p - 1)
    if wire_mode == "allgather":
        return p - 1
    if wire_mode == "gtopk_hier":
        return tree_rounds(max(1, p // max(1, int(ici_size))))
    # gtopk / gtopk_layerwise hypercube tree
    return tree_rounds(p)


def _finite(x: Any) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def _committed_beta() -> float:
    """The committed gloo fit's bandwidth: the baseline when none is
    given."""
    return comm_model.load_fit(comm_model.committed_fit("gloo"))["beta_gbps"]


def fit_alpha_beta(samples,
                   baseline_beta_gbps: Optional[float] = None
                   ) -> Optional[Dict[str, Any]]:
    """Robust {alpha_ms, beta_gbps} from (msgs, wire_bytes, t_comm_ms)
    triples. Theil-Sen over per-message-normalized points; None below 2
    usable samples. ``identifiable`` reports whether the byte spread
    supported a slope ("alpha_beta") or the fit held beta at
    ``baseline_beta_gbps`` ("alpha_only"; default the committed card
    fit's). ``resid_ms`` is the median
    absolute residual in ms-per-message — the fit's noise floor."""
    pts: List[Tuple[float, float]] = []
    for msgs, wire_bytes, t_ms in samples:
        if (not _finite(msgs) or msgs <= 0 or not _finite(wire_bytes)
                or wire_bytes <= 0 or not _finite(t_ms) or t_ms <= 0):
            continue
        pts.append((float(wire_bytes) / msgs, float(t_ms) / msgs))
    if len(pts) < 2:
        return None
    pts.sort()
    xs = [x for x, _ in pts]
    x_med = statistics.median(xs)
    spread = ((max(xs) - min(xs)) / x_med) if x_med > 0 else 0.0
    slope = None
    if spread >= _MIN_X_SPREAD:
        slopes = []
        for i in range(len(pts)):
            xi, yi = pts[i]
            for xj, yj in pts[i + 1:]:
                if xj > xi:
                    slopes.append((yj - yi) / (xj - xi))
        if slopes:
            slope = statistics.median(slopes)
    if slope is None or slope <= 0:
        # Slope unidentifiable (constant bytes, or noise produced a
        # non-physical negative): hold beta at the baseline, fit alpha.
        beta = float(baseline_beta_gbps or 0.0) or _committed_beta()
        slope_used = _MS_PER_BYTE_AT_1GBPS / beta
        identifiable = "alpha_only"
    else:
        beta = _MS_PER_BYTE_AT_1GBPS / slope
        slope_used = slope
        identifiable = "alpha_beta"
    alpha = max(0.0, statistics.median(
        [y - slope_used * x for x, y in pts]))
    resid = statistics.median(
        [abs(y - (alpha + slope_used * x)) for x, y in pts])
    return {"alpha_ms": float(alpha), "beta_gbps": float(beta),
            "n_samples": len(pts), "resid_ms": float(resid),
            "identifiable": identifiable}


def load_fit_file(path: str) -> Dict[str, Any]:
    """Explicit fit-file loader (the ``--comm-model-fit PATH`` override):
    any ``alpha_beta_fit`` shaped JSON (``comm_probe``'s, a calib_fit),
    through ``parallel.comm_model.load_fit``. Raises ValueError on a file
    without a usable ``alpha_beta_fit``: an explicit flag fails at
    start-up, never silently falls back."""
    if not os.path.exists(path):
        raise ValueError(f"{path}: no such fit file")
    return comm_model.load_fit(path)


def _ratio_x(fit: Optional[float], ref: Optional[float]
             ) -> Optional[float]:
    """Symmetric divergence factor max(fit/ref, ref/fit), floored at
    1e-6 per side so a collapsed-to-zero fit reads as a huge (finite)
    drift rather than a JSON-breaking inf."""
    if not _finite(fit) or not _finite(ref):
        return None
    a, b = max(float(fit), 1e-6), max(float(ref), 1e-6)
    return max(a / b, b / a)


class CommCalibrator:
    """Online fitter over the run's own measured (wire_bytes, t_comm)
    samples.

    ``wire_mode``/``p`` fix the message-count normalization (the
    schedule that actually runs — CommPlan.wire_mode); ``baseline`` is
    the planner's inputs ({alpha_ms, beta_gbps, ici_gbps, fit_source}
    of ``PlanDecision.inputs``) that drift is measured against, and the
    carve's constants for the per-axis split;
    ``metrics`` a MetricsLogger (or None for in-memory use); ``monitor``
    an AnomalyMonitor fed through ``observe_comm_model`` on every refit.
    A refit runs every ``refit_interval`` NEW samples once
    ``min_samples`` have accumulated."""

    def __init__(self, wire_mode: str, p: int, *,
                 baseline: Optional[Mapping[str, Any]] = None,
                 metrics=None, monitor=None,
                 refit_interval: int = 4, min_samples: int = 4,
                 fit_window: int = _FIT_WINDOW,
                 max_samples: int = 4096, ici_size: int = 1):
        self.wire_mode = str(wire_mode)
        self.p = int(p)
        self.ici_size = max(1, int(ici_size))
        self.msgs = message_count(self.wire_mode, self.p,
                                  ici_size=self.ici_size)
        self.baseline = dict(baseline) if baseline else {}
        self.metrics = metrics
        self.monitor = monitor
        self.refit_interval = max(1, int(refit_interval))
        self.min_samples = max(2, int(min_samples))
        self.fit_window = max(2, int(fit_window))
        self.max_samples = max(self.fit_window, int(max_samples))
        # (msgs, wire_bytes, t_comm_ms) triples, oldest first.
        self.samples: List[Tuple[int, float, float]] = []
        # Per-axis sample pools: each blended sample is split per mesh
        # axis by the weather map's proportional carve (the rank-0 view
        # of the schedule — symmetric for the modes we run), so hier's
        # ici and dcn hops accumulate SEPARATE (msgs, bytes, t) pools
        # and refit/write_artifact can price each hop from its own
        # measured fit. For single-axis modes the "dcn" pool mirrors
        # the blended one (and its fit matches the blended fit).
        self._axis_rounds = _linkmap.rank_rounds(
            _linkmap.round_peers(self.wire_mode, self.p,
                                 ici_size=self.ici_size), 0)
        self.axis_samples: Dict[str, List[Tuple[int, float, float]]] = {}
        # Last per-axis refit fits, keyed by axis name.
        self.axis_fits: Dict[str, Dict[str, Any]] = {}
        # Samples measured under an OVERLAPPED pipeline, kept apart:
        # their t_comm is the exposed (partially hidden) span, so the
        # per-message alpha-beta inversion does not hold for them —
        # folding them in would bias the serial fit low. Tagged via
        # observe(..., overlapped=True), counted in the calib record,
        # never fitted.
        self.overlap_samples: List[Tuple[int, float, float]] = []
        # First completed fit — the "startup fit" drift is reported
        # against (did the fabric change DURING the run?).
        self.startup_fit: Optional[Dict[str, Any]] = None
        self.fits: List[Dict[str, Any]] = []
        self._pending = 0

    def _base_beta(self) -> float:
        """The baseline bandwidth: the planner's, else the committed
        card fit's."""
        return self.baseline.get("beta_gbps") or _committed_beta()

    def observe(self, step: int, wire_bytes: float, t_comm_ms: float,
                msgs: Optional[int] = None,
                overlapped: bool = False) -> Optional[Dict[str, Any]]:
        """Ingest one measured sample; returns the ``calib`` record when
        this sample completed a refit window, else None. ``msgs``
        overrides the per-merge message count (bucketed runs: B merges
        per step multiply it). ``overlapped`` tags a sample measured
        under the overlapped bucket pipeline: its t_comm is the exposed
        span with part of the wire time hidden under selection, so it
        is retained separately (``overlap_samples``) and NEVER enters
        the serial alpha-beta fit. Raises AnomalyHalt through the
        monitor when a refit's drift reaches the halt severity — after
        the calib record is durably written."""
        m = self.msgs if msgs is None else int(msgs)
        if (m <= 0 or not _finite(wire_bytes) or wire_bytes <= 0
                or not _finite(t_comm_ms) or t_comm_ms <= 0):
            return None
        if overlapped:
            self.overlap_samples.append(
                (m, float(wire_bytes), float(t_comm_ms)))
            if len(self.overlap_samples) > self.max_samples:
                del self.overlap_samples[
                    :len(self.overlap_samples) - self.max_samples]
            return None
        self.samples.append((m, float(wire_bytes), float(t_comm_ms)))
        if len(self.samples) > self.max_samples:
            del self.samples[:len(self.samples) - self.max_samples]
        self._split_axes(m, float(wire_bytes), float(t_comm_ms))
        self._pending += 1
        if (self._pending >= self.refit_interval
                and len(self.samples) >= self.min_samples):
            return self.refit(step)
        return None

    def _split_axes(self, msgs: int, wire_bytes: float,
                    t_comm_ms: float) -> None:
        """Split one blended sample per mesh axis via the weather map's
        proportional carve and append to the per-axis pools. The axis
        message count scales with any caller msgs override (bucketed
        runs launch B merges per sample)."""
        mine = self._axis_rounds
        if not mine:
            return
        weights = _linkmap.round_weights(
            mine, wire_bytes,
            beta_gbps=self._base_beta(),
            ici_gbps=self.baseline.get("ici_gbps") or self._base_beta(),
            alpha_ms=self.baseline.get("alpha_ms"))
        carved = _linkmap.carve_rounds(t_comm_ms, weights)
        per_round_bytes = wire_bytes / len(mine)
        scale = msgs / self.msgs if self.msgs > 0 else 1.0
        agg: Dict[str, List[float]] = {}
        for rd, t_ms in zip(mine, carved):
            a = agg.setdefault(rd["axis"], [0.0, 0.0, 0.0])
            a[0] += 1.0
            a[1] += per_round_bytes
            a[2] += t_ms
        for axis, (n_rounds, b, t) in agg.items():
            pool = self.axis_samples.setdefault(axis, [])
            pool.append((max(1, round(n_rounds * scale)), b, t))
            if len(pool) > self.max_samples:
                del pool[:len(pool) - self.max_samples]

    def _fit_axes(self, window: Optional[int]
                  ) -> Dict[str, Dict[str, Any]]:
        """Per-axis alpha/beta fits over the newest ``window`` samples
        of each pool (None = all). Only axes whose pool supports a fit
        appear; ici pools fall back to the ici baseline bandwidth when
        the slope is unidentifiable."""
        out: Dict[str, Dict[str, Any]] = {}
        for axis in sorted(self.axis_samples):
            pool = self.axis_samples[axis]
            if window is not None:
                pool = pool[-window:]
            if len(pool) < self.min_samples:
                continue
            base_beta = (
                (self.baseline.get("ici_gbps") or self._base_beta())
                if axis == _linkmap.AXIS_ICI else self._base_beta())
            fit = fit_alpha_beta(pool, baseline_beta_gbps=base_beta)
            if fit is not None:
                out[axis] = fit
        return out

    def refit(self, step: int) -> Optional[Dict[str, Any]]:
        """Fit over the newest window, log the ``calib`` record
        (flush=True), feed the drift rule. None below min data."""
        fit = fit_alpha_beta(
            self.samples[-self.fit_window:],
            baseline_beta_gbps=self._base_beta())
        if fit is None:
            return None
        self._pending = 0
        base_a = self.baseline.get("alpha_ms")
        base_b = self.baseline.get("beta_gbps")
        rec: Dict[str, Any] = {
            "step": int(step),
            "alpha_fit_ms": round(fit["alpha_ms"], 6),
            "beta_fit_gbps": round(fit["beta_gbps"], 6),
            "n_samples": fit["n_samples"],
            "resid_ms": round(fit["resid_ms"], 6),
            "identifiable": fit["identifiable"],
            "wire_mode": self.wire_mode,
            "p": self.p,
        }
        if self.overlap_samples:
            # Visible evidence the exclusion worked: how many tagged
            # overlapped samples were kept OUT of this serial fit.
            rec["n_overlap_excluded"] = len(self.overlap_samples)
        if self.baseline.get("fit_source") is not None:
            rec["planner_fit_source"] = self.baseline["fit_source"]
        da, db = _ratio_x(fit["alpha_ms"], base_a), _ratio_x(
            fit["beta_gbps"], base_b)
        if da is not None:
            rec["drift_alpha_x"] = round(da, 6)
        if db is not None:
            rec["drift_beta_x"] = round(db, 6)
        # Per-axis fits ride the same record under dotted keys (the
        # registry flattens them as alpha_ms.<axis> stats): for hier
        # this prices the ici and dcn hops separately; for single-axis
        # modes the dcn fit mirrors the blended one.
        self.axis_fits = self._fit_axes(self.fit_window)
        for axis, axfit in sorted(self.axis_fits.items()):
            rec[f"alpha_ms.{axis}"] = round(axfit["alpha_ms"], 6)
            rec[f"beta_gbps.{axis}"] = round(axfit["beta_gbps"], 6)
            rec[f"n_samples.{axis}"] = axfit["n_samples"]
        if self.startup_fit is None:
            self.startup_fit = dict(fit)
        else:
            sa = _ratio_x(fit["alpha_ms"], self.startup_fit["alpha_ms"])
            sb = _ratio_x(fit["beta_gbps"], self.startup_fit["beta_gbps"])
            if sa is not None:
                rec["drift_alpha_startup_x"] = round(sa, 6)
            if sb is not None:
                rec["drift_beta_startup_x"] = round(sb, 6)
        self.fits.append(rec)
        # Record FIRST (fsync'd), then the rule — a drift halt must not
        # lose the fit that triggered it.
        if self.metrics is not None:
            self.metrics.log("calib", flush=True, **rec)
        if self.monitor is not None and (base_a is not None
                                         or base_b is not None):
            self.monitor.observe_comm_model(
                int(step), fit["alpha_ms"], fit["beta_gbps"],
                ref_alpha_ms=base_a, ref_beta_gbps=base_b,
                fit_source=self.baseline.get("fit_source"))
        return rec

    def final_fit(self) -> Optional[Dict[str, Any]]:
        """Fit over every retained sample (not just the last window) —
        what the end-of-run artifact records."""
        return fit_alpha_beta(
            self.samples,
            baseline_beta_gbps=self._base_beta())

    def final_axis_fits(self) -> Dict[str, Dict[str, Any]]:
        """Per-axis fits over every retained sample — the artifact's
        ``axes`` section."""
        return self._fit_axes(None)

    def write_artifact(self, out_dir: str, *,
                       manifest: Optional[Mapping[str, Any]] = None,
                       nprocs: Optional[int] = None) -> Optional[str]:
        """Write ``calib_fit_{P}proc.json`` (atomic rename) in the
        ``alpha_beta_fit`` grammar that ``ledger.load_alpha_beta`` reads
        first and ``--comm-model-fit`` takes. ``manifest`` stamps run
        provenance (config_hash, git_sha, headline flags) and the card
        it was measured on (``card``: name and power limit as nvidia-smi
        reports them; the backend). Returns the path, or None when too
        few samples ever arrived."""
        fit = self.final_fit()
        if fit is None:
            return None
        procs = int(nprocs if nprocs is not None else self.p)
        provenance: Dict[str, Any] = {}
        for key in ("config_hash", "git_sha", "compression", "density",
                    "wire_codec", "nworkers", "comm_plan_schedule",
                    "backend", "device_name", "power_limit"):
            if manifest is not None and manifest.get(key) is not None:
                provenance[key] = manifest[key]
        card = None
        if provenance.get("device_name"):
            card = ", ".join(str(provenance[key]) for key in
                             ("device_name", "power_limit")
                             if provenance.get(key))
        beta = round(fit["beta_gbps"], 3)
        if beta <= 0:  # sub-milli-Gbps fabric: keep full precision
            beta = fit["beta_gbps"]
        payload = {
            "procs": procs,
            "source": "obs/calib.py",
            "card": card,
            "wire_mode": self.wire_mode,
            "n_samples": len(self.samples),
            "provenance": provenance,
            "alpha_beta_fit": {
                "alpha_ms": round(fit["alpha_ms"], 4),
                "beta_gbps": beta,
                "n_samples": fit["n_samples"],
                "resid_ms": round(fit["resid_ms"], 6),
                "identifiable": fit["identifiable"],
                "note": ("t(bytes) = alpha + bytes*8/beta_gbps/1e9; "
                         "fitted in-run from measured (wire_bytes, "
                         "t_comm) samples, Theil-Sen per-message "
                         "normalization (obs/calib.py)"),
            },
        }
        # Per-axis section (ici/dcn): ledger.load_alpha_beta carries it
        # through. Only axes with a usable fit appear.
        axes = {}
        for axis, axfit in sorted(self.final_axis_fits().items()):
            axes[axis] = {
                "alpha_ms": round(axfit["alpha_ms"], 4),
                "beta_gbps": (round(axfit["beta_gbps"], 3)
                              if axfit["beta_gbps"] > 1e-3
                              else axfit["beta_gbps"]),
                "n_samples": axfit["n_samples"],
                "resid_ms": round(axfit["resid_ms"], 6),
                "identifiable": axfit["identifiable"],
            }
        if axes:
            payload["axes"] = axes
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"calib_fit_{procs}proc.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)
        return path
