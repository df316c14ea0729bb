"""Online anomaly events, the port of ``gtopkssgd_tpu/obs/events.py``: the
run notices its own failures in flight.

arXiv:1911.08772 ties top-k-with-error-feedback convergence to the
residual dynamics, which the on-device counters (``obs.counters``) report
every step. ``AnomalyMonitor`` reads that stream inside the train loop, at
the cadence the trainer already reads the device (no extra device reads).
Every rule of the JAX package is here, and each has its feed: the
trainer calls ``observe`` (the first five rules); the planes call the
others -- ``observe_comm_model`` the calibrator (``obs.calib``),
``observe_compile`` and ``observe_memory`` the memory watch
(``obs.memwatch``), ``observe_critpath`` the trainer's "critpath" records
and the fleet join (``obs.critpath``, ``obs.fleet``), ``observe_goodput``
the goodput ledger (``obs.goodput``), ``observe_links`` the link map
(``obs.linkmap``), ``observe_forecast`` the forecaster (``obs.forecast``)
and ``observe_ranks`` the fleet merge (``obs.fleet``, offline in ``report
fleet``):

  rule                  severity  fires when
  --------------------  --------  -------------------------------------
  nan_loss              error     loss is NaN/Inf
  loss_spike            warn      EWMA z-score of the loss exceeds
                                  ``loss_spike_z`` (after warmup)
  density_collapse      warn      achieved_density < collapse_frac * rho
                                  (sparse modes; selection went degenerate)
  residual_blowup       warn      residual_norm > blowup_x * its EWMA
                                  (error feedback diverging, after warmup)
  residual_age_runaway  warn      max per-layer mean residual age >
                                  age_max steps (starved coordinates;
                                  auto threshold 100/rho — uniform
                                  rotation re-ships a coordinate every
                                  ~1/rho steps)
  straggler_persistent  warn      a rank's EWMA sync-point lag exceeds
                                  straggler_lag_s (auto: straggler_lag_x
                                  x the observed step duration) after
                                  straggler_warmup merged steps — the
                                  same host is late EVERY step, not a
                                  one-off GC pause. Fed by the fleet
                                  merger (obs/fleet.py) through
                                  ``observe_ranks``, so --obs-halt-on
                                  covers it like any other rule
  comm_model_drift      warn      the live calibrator's alpha/beta fit
                                  (obs/calib.py) diverges from the
                                  planner's committed inputs by more
                                  than ``comm_drift_x`` in either
                                  direction, after ``comm_drift_warmup``
                                  prior refits — the comm model that
                                  priced the schedule/bucketing no
                                  longer describes the fabric. Fed by
                                  CommCalibrator.refit through
                                  ``observe_comm_model``
  recompile_storm       warn      the jitted step's executable cache
                                  grew after ``recompile_warmup`` prior
                                  polls — a drifting dispatch shape is
                                  retracing the hot step every few
                                  dispatches. Fed by obs/memwatch.py's
                                  CompileWatch through
                                  ``observe_compile``
  device_mem_leak       warn      sampled live-array bytes grew across
                                  ``mem_leak_windows`` CONSECUTIVE
                                  windows (a plateau resets the streak;
                                  fires once per monotonic run). Fed by
                                  the live-memory watch (obs/memwatch)
                                  through ``observe_memory``
  hbm_headroom          warn      device bytes_in_use crossed
                                  ``hbm_headroom_frac`` of bytes_limit
                                  (fires on the crossing; re-arms when
                                  usage drops back under). Same feed as
                                  device_mem_leak
  critpath_shift        warn      the fleet's global critical stage
                                  (obs/critpath.py via the fleet join)
                                  differed from the established modal
                                  stage for ``critpath_shift_windows``
                                  CONSECUTIVE joined steps — the step's
                                  bottleneck moved (e.g. compute→wait:
                                  a peer started skewing the
                                  collective). Fires once per shift,
                                  then adopts the new stage as modal
                                  and re-arms. Fed by the fleet merger
                                  through ``observe_critpath``
  goodput_collapse      warn      the run's cumulative goodput_frac
                                  (obs/goodput.py ledger) dropped below
                                  ``goodput_collapse_frac`` x its own
                                  EWMA for ``goodput_collapse_windows``
                                  CONSECUTIVE ledger observations —
                                  wall-clock is still passing but it
                                  stopped buying training progress
                                  (storm of waits/recoveries/ckpts).
                                  Fed by the GoodputLedger's periodic
                                  durable records through
                                  ``observe_goodput``
  link_degraded         warn      one link's EWMA latency in the
                                  weather map (obs/linkmap.py) stayed
                                  above ``link_degraded_x`` x the
                                  fleet-median link EWMA for
                                  ``link_degraded_windows`` CONSECUTIVE
                                  observations — a specific (axis,
                                  peer-pair) hop degraded, not just
                                  "some rank is slow". The streak IS
                                  the warmup (no single-window fire);
                                  fires once per streak, then re-arms.
                                  Fed by LinkMap.observe through
                                  ``observe_links`` AFTER the durable
                                  linkmap record is written
  forecast_drift        warn      the forecast plane's hindcast error
                                  (obs/forecast.py: predicted vs
                                  measured step time on THIS run)
                                  stayed beyond ``forecast_drift_x`` for
                                  ``forecast_drift_windows`` CONSECUTIVE
                                  observations — the digital twin no
                                  longer explains the run it was fitted
                                  on, so its P-target recommendations
                                  are not evidence. The streak IS the
                                  warmup; fires once per streak, then
                                  re-arms. Fed by StepForecaster.observe
                                  through ``observe_forecast`` AFTER the
                                  durable forecast record is written

Every rule name is registered in the module-level ``RULES`` frozenset
(the event-plane mirror of ``utils/metrics.KINDS``): ``_emit`` rejects
unregistered names.

Each firing emits one severity-tagged ``event`` record through
MetricsLogger with ``flush=True`` (fsync'd — a run killed one line later
keeps its diagnosis) and an instant marker on the timeline when one is
recording. ``halt_on`` turns detection into fail-fast: observing an event
at (or above) that severity raises ``AnomalyHalt`` after the record is
durably written, and ``dist_trainer`` maps it to exit code 44 (the
watchdog owns 43).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

# Exit code for --obs-halt-on fail-fast (watchdog stalls exit EXIT_STALL),
# from the port's exit_codes.py.
from gtopkssgd_tpu_torch.exit_codes import EXIT_ANOMALY_HALT as HALT_EXIT_CODE

_SEVERITY_RANK = {"info": 0, "warn": 1, "error": 2}

# Every rule name the monitor may emit -- the event-plane mirror of
# utils/metrics.KINDS. An event record whose "rule" is not here is a bug
# (a typo'd emit site, an undocumented rule): _emit raises.
RULES = frozenset({
    "nan_loss",              # non-finite loss (error)
    "loss_spike",            # loss EWMA z-score excursion
    "density_collapse",      # achieved density << configured rho
    "residual_blowup",       # error-feedback residual diverging
    "residual_age_runaway",  # starved coordinates (stale residuals)
    "straggler_persistent",  # one rank late at EVERY sync point
    "comm_model_drift",      # live alpha/beta fit off the planner's
    "recompile_storm",       # executable cache growing on the hot step
    "device_mem_leak",       # live bytes growing monotonically
    "hbm_headroom",          # bytes_in_use near bytes_limit
    "critpath_shift",        # global critical stage moved
    "goodput_collapse",      # goodput_frac fell off its own EWMA
    "link_degraded",         # one (axis, peer) link's EWMA pulled away
                             # from the fleet median (obs/linkmap.py)
    "forecast_drift",        # hindcast error beyond bound — the model
                             # stopped explaining the run (obs/forecast)
})


class AnomalyHalt(RuntimeError):
    """Raised by AnomalyMonitor.observe when an event reaches the
    configured halt severity. Carries the triggering event record."""

    def __init__(self, event: Dict[str, Any]):
        super().__init__(
            f"anomaly halt: {event.get('rule')} "
            f"(severity={event.get('severity')}, step={event.get('step')}, "
            f"value={event.get('value')})")
        self.event = event


@dataclasses.dataclass
class Thresholds:
    """Rule thresholds, the JAX package's defaults."""

    loss_spike_z: float = 6.0        # EWMA z-score
    loss_ewma_alpha: float = 0.1     # EWMA decay for loss mean/var
    loss_warmup: int = 5             # observations before spike/blowup arm
    density_collapse_frac: float = 0.1   # achieved < frac * rho
    residual_blowup_x: float = 10.0  # residual_norm vs its EWMA
    residual_age_max: float = 0.0    # steps; 0 = auto (100 / rho)
    straggler_lag_s: float = 0.0     # seconds; 0 = auto (lag_x * step dur)
    straggler_lag_x: float = 2.0     # auto threshold: x * step duration
    straggler_ewma_alpha: float = 0.3    # EWMA decay for per-rank lag
    straggler_warmup: int = 2        # merged steps before the rule arms
    comm_drift_x: float = 4.0        # live fit vs planner inputs, either
                                     # direction (max of a/b and b/a)
    comm_drift_warmup: int = 2       # refits before the drift rule arms
    recompile_warmup: int = 1        # compile-watch polls before
                                     # recompile_storm arms (0 = any
                                     # cache growth fires, even the
                                     # first poll's)
    mem_leak_windows: int = 3        # consecutive growing live-bytes
                                     # windows before device_mem_leak
    hbm_headroom_frac: float = 0.92  # bytes_in_use / bytes_limit above
                                     # which hbm_headroom fires
    critpath_shift_windows: int = 3  # consecutive joined steps whose
                                     # global critical stage differs
                                     # from the modal one before
                                     # critpath_shift fires
    goodput_collapse_windows: int = 3    # consecutive ledger records
                                         # below the drop threshold
                                         # before goodput_collapse fires
    goodput_collapse_frac: float = 0.5   # current goodput_frac < frac *
                                         # its EWMA counts as a drop
    goodput_ewma_alpha: float = 0.3      # EWMA decay for goodput_frac
    goodput_warmup: int = 2          # ledger records before the
                                     # collapse rule arms (early-run
                                     # fractions are startup-dominated)
    link_degraded_x: float = 4.0     # a link's EWMA latency vs the
                                     # fleet-median link EWMA above
                                     # which a window counts as degraded
    link_degraded_windows: int = 3   # consecutive degraded windows
                                     # before link_degraded fires (the
                                     # streak is the rule's warmup —
                                     # one noisy window never fires)
    forecast_drift_x: float = 4.0    # hindcast error factor (predicted
                                     # vs measured step time, either
                                     # direction) above which a window
                                     # counts as drifted
    forecast_drift_windows: int = 3  # consecutive drifted windows
                                     # before forecast_drift fires (the
                                     # streak is the warmup — one noisy
                                     # capture never fires)

    def age_max(self, rho: Optional[float]) -> float:
        if self.residual_age_max > 0:
            return self.residual_age_max
        if rho and rho > 0:
            return 100.0 / rho
        return math.inf

    def straggler_threshold(self, step_dur: Optional[float]) -> float:
        """Seconds of EWMA lag that makes a rank a persistent straggler.
        Explicit straggler_lag_s wins; otherwise auto-scale to the run's
        own cadence (a 50 ms-step fleet and a 5 s-step fleet get sane
        thresholds from the same default). No cadence estimate, no auto
        rule — better silent than noisy."""
        if self.straggler_lag_s > 0:
            return self.straggler_lag_s
        if step_dur is not None and step_dur > 0:
            return self.straggler_lag_x * step_dur
        return math.inf


def _finite(x: Optional[float]) -> bool:
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)


class AnomalyMonitor:
    """Stateful rule evaluator over the per-step (loss, telemetry) stream.

    ``metrics`` is a MetricsLogger (or None for in-memory use);
    ``timeline`` an optional TimelineRecorder; ``rho`` the configured
    density for sparse modes (None disables the density/age rules);
    ``halt_on`` one of None | "warn" | "error" — the minimum severity
    that raises AnomalyHalt."""

    def __init__(self, metrics=None, rho: Optional[float] = None,
                 halt_on: Optional[str] = None,
                 thresholds: Optional[Thresholds] = None,
                 timeline=None):
        if halt_on is not None and halt_on not in _SEVERITY_RANK:
            raise ValueError(
                f"halt_on={halt_on!r} must be one of "
                f"{sorted(_SEVERITY_RANK)} or None")
        self.metrics = metrics
        self.timeline = timeline
        self.rho = rho
        self.halt_on = halt_on
        # Recovery claim hook (resilience/policy.py): called with each
        # fired event; returning True means a recovery action will
        # handle it, which suppresses the halt for that event (the
        # record still lands, tagged claimed=True). None = detect-only.
        self.recovery = None
        self.th = thresholds or Thresholds()
        self.events: List[Dict[str, Any]] = []
        # EWMA state (loss mean/var, residual norm) + sample counts.
        self._loss_mean: Optional[float] = None
        self._loss_var = 0.0
        self._loss_n = 0
        self._res_mean: Optional[float] = None
        self._res_n = 0
        # Per-rank EWMA of sync-point lag (seconds), fed by observe_ranks
        # from the fleet merger; public — fleet straggler rows report it.
        self.rank_lag_ewma: Dict[int, float] = {}
        self._rank_lag_n: Dict[int, int] = {}
        # Refits seen so far, fed by the comm calibrator — the drift
        # rule arms only after comm_drift_warmup prior refits.
        self._comm_fit_n = 0
        # Compile-plane state (observe_compile): polls seen so far —
        # recompile_storm arms only after recompile_warmup prior polls.
        self._compile_n = 0
        # Memory-plane state (observe_memory): last live-bytes sample,
        # the current growth streak, and the per-rule latches (leak
        # fires once per monotonic run; headroom once per crossing).
        self._mem_last: Optional[float] = None
        self._mem_grow = 0
        self._mem_leak_fired = False
        self._headroom_over = False
        # Critical-path state (observe_critpath): the established modal
        # critical stage, plus the current differing streak and the
        # stage it has settled on. The first observation sets the modal
        # stage (inherent warmup — nothing can fire before a modal
        # stage exists to shift FROM).
        self._crit_modal: Optional[str] = None
        self._crit_streak = 0
        self._crit_streak_stage: Optional[str] = None
        # Goodput state (observe_goodput): EWMA of the run's cumulative
        # goodput_frac, observations seen, and the current below-
        # threshold streak.
        self._gp_ewma: Optional[float] = None
        self._gp_n = 0
        self._gp_streak = 0
        # Link-plane state (observe_links): per-link consecutive
        # degraded-window streaks. A link leaving the offender set
        # drops its streak entirely (re-arm on recovery).
        self._link_streaks: Dict[str, int] = {}
        # Forecast-plane state (observe_forecast): the current
        # consecutive hindcast-drifted streak. Recovery resets it.
        self._fc_streak = 0

    # ---------------------------------------------------------- the rules
    def _check(self, step: int, loss: Optional[float],
               telemetry: Optional[Dict[str, float]],
               max_residual_age: Optional[float]) -> List[Dict[str, Any]]:
        th = self.th
        out: List[Dict[str, Any]] = []

        def fire(rule, severity, value, threshold, message):
            out.append({
                "rule": rule, "severity": severity, "step": step,
                "value": round(float(value), 6) if _finite(value) else None,
                "threshold": (round(float(threshold), 6)
                              if math.isfinite(threshold) else None),
                "message": message,
            })

        if loss is not None and not _finite(loss):
            fire("nan_loss", "error", loss, math.nan,
                 f"non-finite loss at step {step}")
        elif _finite(loss):
            if (self._loss_n >= th.loss_warmup and self._loss_var > 0):
                z = (loss - self._loss_mean) / math.sqrt(self._loss_var)
                if z > th.loss_spike_z:
                    fire("loss_spike", "warn", z, th.loss_spike_z,
                         f"loss {loss:.4g} is {z:.1f} sigma above its "
                         f"EWMA {self._loss_mean:.4g}")
            a = th.loss_ewma_alpha
            if self._loss_mean is None:
                self._loss_mean = float(loss)
            else:
                d = float(loss) - self._loss_mean
                self._loss_mean += a * d
                self._loss_var = (1 - a) * (self._loss_var + a * d * d)
            self._loss_n += 1

        tel = telemetry or {}
        dens = tel.get("achieved_density")
        if (self.rho and _finite(dens)
                and dens < th.density_collapse_frac * self.rho):
            fire("density_collapse", "warn", dens,
                 th.density_collapse_frac * self.rho,
                 f"achieved density {dens:.3g} collapsed below "
                 f"{th.density_collapse_frac:g} x rho={self.rho:g}")

        res = tel.get("residual_norm")
        if _finite(res):
            if (self._res_n >= th.loss_warmup and self._res_mean
                    and res > th.residual_blowup_x * self._res_mean):
                fire("residual_blowup", "warn", res,
                     th.residual_blowup_x * self._res_mean,
                     f"residual norm {res:.4g} blew past "
                     f"{th.residual_blowup_x:g} x EWMA "
                     f"{self._res_mean:.4g}")
            a = th.loss_ewma_alpha
            self._res_mean = (float(res) if self._res_mean is None
                              else self._res_mean
                              + a * (float(res) - self._res_mean))
            self._res_n += 1

        age_max = th.age_max(self.rho)
        if _finite(max_residual_age) and max_residual_age > age_max:
            fire("residual_age_runaway", "warn", max_residual_age, age_max,
                 f"max per-layer mean residual age {max_residual_age:.0f} "
                 f"steps exceeds {age_max:.0f} (starved coordinates)")
        return out

    # ------------------------------------------------- straggler (fleet)
    def _check_ranks(self, step: int, lags: Dict[int, float],
                     step_dur: Optional[float]) -> List[Dict[str, Any]]:
        th = self.th
        threshold = th.straggler_threshold(step_dur)
        out: List[Dict[str, Any]] = []
        for rank in sorted(lags):
            lag = float(lags[rank])
            if not _finite(lag):
                continue
            # Arm-before-update, like residual_blowup: a rank must have
            # been late for straggler_warmup prior merged steps before
            # its current EWMA can fire — one slow step never does.
            ewma = self.rank_lag_ewma.get(rank)
            n = self._rank_lag_n.get(rank, 0)
            if (n >= th.straggler_warmup and ewma is not None
                    and ewma > threshold):
                out.append({
                    "rule": "straggler_persistent", "severity": "warn",
                    "step": step, "value": round(ewma, 6),
                    "threshold": (round(threshold, 6)
                                  if math.isfinite(threshold) else None),
                    "rank_behind": rank,
                    "message": (f"rank {rank} EWMA sync lag {ewma:.3g}s "
                                f"exceeds {threshold:.3g}s over {n} "
                                "merged steps (persistent straggler)"),
                })
            a = th.straggler_ewma_alpha
            self.rank_lag_ewma[rank] = (
                lag if ewma is None else ewma + a * (lag - ewma))
            self._rank_lag_n[rank] = n + 1
        return out

    # --------------------------------------------- comm model drift (calib)
    def _check_comm_model(self, step: int, alpha_ms: Optional[float],
                          beta_gbps: Optional[float],
                          ref_alpha_ms: Optional[float],
                          ref_beta_gbps: Optional[float],
                          fit_source: Optional[str]
                          ) -> List[Dict[str, Any]]:
        th = self.th
        worst = None  # (factor, name, fit, ref)
        for name, fit, ref in (("alpha_ms", alpha_ms, ref_alpha_ms),
                               ("beta_gbps", beta_gbps, ref_beta_gbps)):
            if not _finite(fit) or not _finite(ref):
                continue
            # Floor both sides so a fit collapsing to ~0 reads as a huge
            # finite factor instead of a ZeroDivisionError.
            a, b = max(float(fit), 1e-6), max(float(ref), 1e-6)
            factor = max(a / b, b / a)
            if worst is None or factor > worst[0]:
                worst = (factor, name, fit, ref)
        out: List[Dict[str, Any]] = []
        # Arm-before-update, like the straggler rule: the first
        # comm_drift_warmup refits (the fit is still converging on few
        # samples) can never fire.
        if (worst is not None and self._comm_fit_n >= th.comm_drift_warmup
                and worst[0] > th.comm_drift_x):
            factor, name, fit, ref = worst
            src = f" (planner fit: {fit_source})" if fit_source else ""
            out.append({
                "rule": "comm_model_drift", "severity": "warn",
                "step": step, "value": round(factor, 6),
                "threshold": round(th.comm_drift_x, 6),
                "param": name,
                "message": (f"live {name} fit {float(fit):.4g} is "
                            f"{factor:.3g}x off the planner's committed "
                            f"{float(ref):.4g}{src} — the comm model "
                            "that priced this run's schedule is stale"),
            })
        if worst is not None:
            self._comm_fit_n += 1
        return out

    # ---------------------------------------------- compile plane (memwatch)
    def _check_compile(self, step: int, cache_size: Optional[int],
                       grew: bool) -> List[Dict[str, Any]]:
        th = self.th
        out: List[Dict[str, Any]] = []
        # Arm-before-update, like the drift rule: growth observed within
        # the first recompile_warmup polls is warm-up compilation (a new
        # dispatch shape the run was always going to trace), not a storm.
        if grew and self._compile_n >= th.recompile_warmup:
            out.append({
                "rule": "recompile_storm", "severity": "warn",
                "step": step,
                "value": (round(float(cache_size), 6)
                          if _finite(cache_size) else None),
                "threshold": round(float(th.recompile_warmup), 6),
                "message": (f"jit executable cache grew to {cache_size} "
                            f"entries at step {step} after "
                            f"{self._compile_n} warm polls — a drifting "
                            "dispatch shape is retracing the hot step"),
            })
        self._compile_n += 1
        return out

    # ----------------------------------------------- memory plane (memwatch)
    def _check_memory(self, step: int, live_bytes: Optional[float],
                      bytes_in_use: Optional[float],
                      bytes_limit: Optional[float]
                      ) -> List[Dict[str, Any]]:
        th = self.th
        out: List[Dict[str, Any]] = []
        if _finite(live_bytes):
            if self._mem_last is not None and live_bytes > self._mem_last:
                self._mem_grow += 1
            else:
                # A plateau or shrink resets both the streak and the
                # latch — the NEXT monotonic run may fire again.
                self._mem_grow = 0
                self._mem_leak_fired = False
            self._mem_last = float(live_bytes)
            if (self._mem_grow >= th.mem_leak_windows
                    and not self._mem_leak_fired):
                self._mem_leak_fired = True
                out.append({
                    "rule": "device_mem_leak", "severity": "warn",
                    "step": step, "value": round(float(live_bytes), 6),
                    "threshold": round(float(th.mem_leak_windows), 6),
                    "message": (f"live device bytes grew for "
                                f"{self._mem_grow} consecutive windows "
                                f"to {live_bytes:.4g} — buffers are "
                                "accumulating (leak or unbounded cache)"),
                })
        if (_finite(bytes_in_use) and _finite(bytes_limit)
                and bytes_limit > 0):
            frac = float(bytes_in_use) / float(bytes_limit)
            if frac > th.hbm_headroom_frac:
                if not self._headroom_over:
                    self._headroom_over = True
                    out.append({
                        "rule": "hbm_headroom", "severity": "warn",
                        "step": step, "value": round(frac, 6),
                        "threshold": round(th.hbm_headroom_frac, 6),
                        "message": (f"device memory {frac:.1%} of "
                                    f"bytes_limit exceeds "
                                    f"{th.hbm_headroom_frac:.0%} — the "
                                    "next allocation spike can OOM"),
                    })
            else:
                self._headroom_over = False
        return out

    # ------------------------------------------- critical path (fleet)
    def _check_critpath(self, step: int, crit_stage: Optional[str]
                        ) -> List[Dict[str, Any]]:
        th = self.th
        out: List[Dict[str, Any]] = []
        if not crit_stage:
            return out
        if self._crit_modal is None:
            # Inherent warmup: the first joined step ESTABLISHES the
            # modal stage; there is nothing to shift from yet.
            self._crit_modal = crit_stage
            return out
        if crit_stage == self._crit_modal:
            self._crit_streak = 0
            self._crit_streak_stage = None
            return out
        # Differing stage: extend the streak only while it stays on ONE
        # new stage — a noisy alternation (comm, wait, comm, ...) is not
        # a shift, it's churn, and restarts the count.
        if crit_stage == self._crit_streak_stage:
            self._crit_streak += 1
        else:
            self._crit_streak_stage = crit_stage
            self._crit_streak = 1
        if self._crit_streak >= th.critpath_shift_windows:
            out.append({
                "rule": "critpath_shift", "severity": "warn",
                "step": step, "value": float(self._crit_streak),
                "threshold": round(float(th.critpath_shift_windows), 6),
                "from_stage": self._crit_modal, "to_stage": crit_stage,
                "message": (f"global critical stage shifted "
                            f"{self._crit_modal}->{crit_stage} for "
                            f"{self._crit_streak} consecutive joined "
                            "steps — the step's bottleneck moved"),
            })
            # Adopt the new stage and re-arm: the next shift is judged
            # against what the fleet is NOW bounded by.
            self._crit_modal = crit_stage
            self._crit_streak = 0
            self._crit_streak_stage = None
        return out

    # ------------------------------------------------ goodput (ledger)
    def _check_goodput(self, step: int, goodput_frac: Optional[float]
                       ) -> List[Dict[str, Any]]:
        th = self.th
        out: List[Dict[str, Any]] = []
        if not _finite(goodput_frac):
            return out
        frac = float(goodput_frac)
        # Arm-before-update, like the straggler/drift rules: the first
        # goodput_warmup ledger records (startup-dominated fractions)
        # establish the EWMA and can never fire; afterwards, a record
        # below goodput_collapse_frac x the EWMA extends the streak, a
        # recovered record resets it.
        if (self._gp_n >= th.goodput_warmup and self._gp_ewma is not None
                and self._gp_ewma > 0
                and frac < th.goodput_collapse_frac * self._gp_ewma):
            self._gp_streak += 1
        else:
            self._gp_streak = 0
        if self._gp_streak >= th.goodput_collapse_windows:
            out.append({
                "rule": "goodput_collapse", "severity": "warn",
                "step": step, "value": round(frac, 6),
                "threshold": round(
                    th.goodput_collapse_frac * self._gp_ewma, 6),
                "message": (f"goodput_frac {frac:.3g} stayed below "
                            f"{th.goodput_collapse_frac:g} x its EWMA "
                            f"{self._gp_ewma:.3g} for "
                            f"{self._gp_streak} consecutive ledger "
                            "records — wall-clock has stopped buying "
                            "training progress"),
            })
            # Re-arm: the EWMA keeps updating with the collapsed
            # fractions below, so a sustained new level is adopted and
            # only a FURTHER collapse fires again.
            self._gp_streak = 0
        a = th.goodput_ewma_alpha
        self._gp_ewma = (frac if self._gp_ewma is None
                         else self._gp_ewma + a * (frac - self._gp_ewma))
        self._gp_n += 1
        return out

    # ------------------------------------------------- link plane (linkmap)
    def _check_links(self, step: int, ewma_ms_by_link: Dict[str, float]
                     ) -> List[Dict[str, Any]]:
        th = self.th
        out: List[Dict[str, Any]] = []
        finite = {str(k): float(v) for k, v in ewma_ms_by_link.items()
                  if _finite(v)}
        # A one-link map has no fleet to compare against (worst == only
        # == median); the rule needs at least two links to mean anything.
        if len(finite) < 2:
            self._link_streaks.clear()
            return out
        vals = sorted(finite.values())
        mid = len(vals) // 2
        median = (vals[mid] if len(vals) % 2
                  else 0.5 * (vals[mid - 1] + vals[mid]))
        if median <= 0:
            return out
        offenders = {k: v for k, v in finite.items()
                     if v > th.link_degraded_x * median}
        # Recovery re-arms: a link back under the threshold loses its
        # streak entirely, so the NEXT degradation starts from zero.
        for key in list(self._link_streaks):
            if key not in offenders:
                del self._link_streaks[key]
        for key in sorted(offenders):
            v = offenders[key]
            n = self._link_streaks.get(key, 0) + 1
            self._link_streaks[key] = n
            if n < th.link_degraded_windows or out:
                continue  # streak still building, or already firing once
            # Fire once per streak, then re-arm this link: a SUSTAINED
            # degradation fires again only after another full streak.
            self._link_streaks[key] = 0
            axis, _, pair = key.partition(":")
            lo, _, hi = pair.partition("-")
            ev = {
                "rule": "link_degraded", "severity": "warn", "step": step,
                "value": round(v / median, 6),
                "threshold": round(th.link_degraded_x, 6),
                "link": key, "axis": axis,
                "ewma_ms": round(v, 6),
                "fleet_median_ms": round(median, 6),
                "windows": n,
                "message": (f"link {key} EWMA {v:.4g} ms stayed above "
                            f"{th.link_degraded_x:g} x the fleet median "
                            f"{median:.4g} ms for {n} consecutive "
                            "windows — that hop degraded, not just "
                            "'some rank is slow'"),
            }
            try:
                ev["src"], ev["dst"] = int(lo), int(hi)
            except ValueError:
                pass
            out.append(ev)
        return out

    # ------------------------------------------- forecast plane (forecast)
    def _check_forecast(self, step: int, err_x: Optional[float]
                        ) -> List[Dict[str, Any]]:
        th = self.th
        out: List[Dict[str, Any]] = []
        if not _finite(err_x):
            return out
        err = float(err_x)
        # Streak-is-the-warmup, like link_degraded: a capture whose
        # hindcast error exceeds the bound extends the streak, a
        # recovered capture resets it, and nothing fires before
        # forecast_drift_windows consecutive drifted captures.
        if err > th.forecast_drift_x:
            self._fc_streak += 1
        else:
            self._fc_streak = 0
        if self._fc_streak >= th.forecast_drift_windows:
            n = self._fc_streak
            # Fire once per streak, then re-arm: a model that STAYS
            # wrong fires again only after another full streak.
            self._fc_streak = 0
            out.append({
                "rule": "forecast_drift", "severity": "warn",
                "step": step, "value": round(err, 6),
                "threshold": round(th.forecast_drift_x, 6),
                "windows": n,
                "message": (f"hindcast error {err:.3g}x stayed beyond "
                            f"{th.forecast_drift_x:g}x for {n} "
                            "consecutive captures — the forecast model "
                            "no longer explains the run it was fitted "
                            "on; its scale-out recommendations are not "
                            "evidence"),
            })
        return out

    # ------------------------------------------------------------- public
    def _emit(self, fired: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Record, persist (fsync'd), mark on the timeline, and — after
        everything is durably written — raise if any event reaches the
        halt severity. Shared by observe and observe_ranks."""
        halting = None
        for ev in fired:
            if ev.get("rule") not in RULES:
                raise ValueError(
                    f"unregistered anomaly rule {ev.get('rule')!r} — "
                    "add it to obs/events.RULES before emitting it")
            # Offer the event to the recovery layer BEFORE the halt
            # decision: a claimed event is about to be recovered from,
            # so halting on it would defeat the policy. The claim is
            # recorded on the event itself (only when a recovery layer
            # exists — detect-only runs keep byte-identical records).
            if self.recovery is not None:
                ev["claimed"] = bool(self.recovery(ev))
            self.events.append(ev)
            if self.metrics is not None:
                self.metrics.log("event", flush=True, **ev)
            if self.timeline is not None:
                self.timeline.instant(f"event:{ev['rule']}", args=ev)
            if (self.halt_on is not None and halting is None
                    and not ev.get("claimed")
                    and _SEVERITY_RANK[ev["severity"]]
                    >= _SEVERITY_RANK[self.halt_on]):
                halting = ev
        if halting is not None:
            raise AnomalyHalt(halting)
        return fired

    def observe(self, step: int, loss: Optional[float] = None,
                telemetry: Optional[Dict[str, float]] = None,
                max_residual_age: Optional[float] = None
                ) -> List[Dict[str, Any]]:
        """Evaluate every rule against one step's synced scalars; emit
        and return the fired events. Raises AnomalyHalt AFTER all records
        are flushed when any event reaches the halt severity."""
        return self._emit(self._check(step, loss, telemetry,
                                      max_residual_age))

    def observe_ranks(self, step: int, lags: Dict[int, float],
                      step_dur: Optional[float] = None
                      ) -> List[Dict[str, Any]]:
        """Evaluate the straggler rule against one merged step's per-rank
        sync-point lags (seconds behind the first rank, from the fleet
        merger). Same emit/halt contract as observe — a persistent
        straggler trips --obs-halt-on warn exactly like a loss spike."""
        return self._emit(self._check_ranks(step, dict(lags), step_dur))

    def observe_comm_model(self, step: int, alpha_ms: Optional[float],
                           beta_gbps: Optional[float], *,
                           ref_alpha_ms: Optional[float] = None,
                           ref_beta_gbps: Optional[float] = None,
                           fit_source: Optional[str] = None
                           ) -> List[Dict[str, Any]]:
        """Evaluate the comm_model_drift rule against one refit of the
        live calibrator (obs/calib.py) vs the planner's committed
        reference fit. Same emit/halt contract as observe — a drifted
        comm model trips --obs-halt-on warn like any other anomaly."""
        return self._emit(self._check_comm_model(
            step, alpha_ms, beta_gbps, ref_alpha_ms, ref_beta_gbps,
            fit_source))

    def observe_compile(self, step: int, *,
                        cache_size: Optional[int] = None,
                        grew: bool = False) -> List[Dict[str, Any]]:
        """Evaluate the recompile_storm rule against one compile-watch
        poll (obs/memwatch.py): the jitted step's executable-cache size
        and whether it grew since the previous poll. Same emit/halt
        contract as observe — a recompile storm trips --obs-halt-on warn
        like any other anomaly."""
        return self._emit(self._check_compile(step, cache_size, grew))

    def observe_memory(self, step: int, *,
                       live_bytes: Optional[float] = None,
                       bytes_in_use: Optional[float] = None,
                       bytes_limit: Optional[float] = None
                       ) -> List[Dict[str, Any]]:
        """Evaluate the device_mem_leak / hbm_headroom rules against one
        live-memory window (obs/memwatch.py sampling). Backends without
        memory_stats feed live_bytes only — the headroom rule simply
        never arms there. Same emit/halt contract as observe."""
        return self._emit(self._check_memory(step, live_bytes,
                                             bytes_in_use, bytes_limit))

    def observe_critpath(self, step: int, *,
                         crit_stage: Optional[str] = None
                         ) -> List[Dict[str, Any]]:
        """Evaluate the critpath_shift rule against one fleet-joined
        step's global critical stage (obs/critpath.py critical_path via
        the fleet merger). Same emit/halt contract as observe — a moved
        bottleneck trips --obs-halt-on warn like any other anomaly."""
        return self._emit(self._check_critpath(step, crit_stage))

    def observe_goodput(self, step: int, *,
                        goodput_frac: Optional[float] = None
                        ) -> List[Dict[str, Any]]:
        """Evaluate the goodput_collapse rule against one periodic
        ledger record's cumulative goodput_frac (obs/goodput.py). Same
        emit/halt contract as observe — the ledger writes its durable
        record BEFORE feeding the monitor, so the decomposition that
        explains the collapse survives the exit-44 halt."""
        return self._emit(self._check_goodput(step, goodput_frac))

    def observe_links(self, step: int, ewma_ms_by_link: Dict[str, float]
                      ) -> List[Dict[str, Any]]:
        """Evaluate the link_degraded rule against one weather-map
        snapshot: {link key ("axis:lo-hi") -> EWMA latency ms} from
        LinkMap (obs/linkmap.py). Same emit/halt contract as observe —
        LinkMap writes its durable linkmap record BEFORE calling this,
        so the evidence naming the degraded hop survives the exit-44
        halt."""
        return self._emit(self._check_links(step, dict(ewma_ms_by_link)))

    def observe_forecast(self, step: int, *,
                         err_x: Optional[float] = None
                         ) -> List[Dict[str, Any]]:
        """Evaluate the forecast_drift rule against one forecast
        capture's hindcast error factor (obs/forecast.py). Same
        emit/halt contract as observe — StepForecaster writes its
        durable forecast record BEFORE calling this, so the prediction
        that failed survives the exit-44 halt."""
        return self._emit(self._check_forecast(step, err_x))

    def summary(self) -> Dict[str, int]:
        """{rule: count} over the monitor's lifetime (test/report aid)."""
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev["rule"]] = out.get(ev["rule"], 0) + 1
        return out
