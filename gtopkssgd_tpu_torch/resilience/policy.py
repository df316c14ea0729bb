"""Recovery policies (``--recover-policy``), the port of
``gtopkssgd_tpu/resilience/policy.py``: AnomalyMonitor rules mapped to
actions instead of exit 44.

Policy grammar (comma-separated rules)::

    POLICY := RULE "=" ACTION [":" BUDGET [":" PARAM]] ("," ...)*

RULE is any AnomalyMonitor rule (nan_loss, loss_spike, density_collapse,
residual_blowup, residual_age_runaway, straggler_persistent). Actions:

  skip      discard the just-dispatched update: restore the pre-step
            state snapshot (params, momentum, step count, and the
            error-feedback residual — bit-identical, which matters
            because arXiv:1911.08772 ties convergence to the residual;
            a recovery that zeroes or advances it is silently wrong).
            BUDGET (default 3) bounds CONSECUTIVE skips: a fault that
            persists through N skipped steps is not transient, and the
            claim is refused so the existing halt semantics (exit 44)
            take over. A clean observed step resets the counter.
  rollback  restore the last good checkpoint and replay from it.
            BUDGET (default 2) bounds total rollbacks per rule; PARAM
            (default 0.5) is the backoff base in seconds, doubling per
            use (0.5, 1, 2, ...). With no checkpoint to roll back to
            the claim escalates to the halt path.
  degrade   swap the sparse exchange for the dense all-reduce (the
            optimizer's dense warm-up branch, selected by a huge
            warmup_dense_steps, over the same state), re-entering sparse
            after a cooldown of PARAM steps (default 50). BUDGET
            (default 3) bounds degrade episodes.

The RecoveryManager is the bridge between the monitor and the trainer:
``claim(event)`` (installed as AnomalyMonitor.recovery) answers "will
recovery handle this?" synchronously inside the monitor's emit — a True
suppresses the halt — and queues the action; the trainer applies queued
actions at the end of the same loop iteration, where it owns the state
snapshot and the data iterators. Every action logs one fsync'd
"recovery" record, and the run ends with a summary record
(action="summary", final_status, n_recoveries).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

ACTIONS = ("skip", "rollback", "degrade")

# Known monitor rules — validated at parse time so a typo'd rule fails
# at argparse, not by silently never matching at 3am.
RULES = ("nan_loss", "loss_spike", "density_collapse", "residual_blowup",
         "residual_age_runaway", "straggler_persistent")

_DEFAULT_BUDGET = {"skip": 3, "rollback": 2, "degrade": 3}
_DEFAULT_PARAM = {"skip": 0.0, "rollback": 0.5, "degrade": 50.0}


@dataclasses.dataclass(frozen=True)
class ActionSpec:
    rule: str
    action: str
    budget: int
    param: float     # rollback: backoff base seconds; degrade: cooldown steps

    def describe(self) -> str:
        bits = f"{self.rule}={self.action}:{self.budget}"
        if self.action == "rollback":
            return bits + f":backoff={self.param:g}s"
        if self.action == "degrade":
            return bits + f":cooldown={self.param:g}"
        return bits


def parse_policy(spec: str) -> Dict[str, ActionSpec]:
    """Parse a ``--recover-policy`` spec into {rule: ActionSpec}."""
    out: Dict[str, ActionSpec] = {}
    for frag in (f.strip() for f in spec.split(",") if f.strip()):
        if "=" not in frag:
            raise ValueError(
                f"recovery rule {frag!r} has no '=' (grammar: "
                "rule=action[:budget[:param]])")
        rule, _, rest = frag.partition("=")
        rule = rule.strip()
        if rule not in RULES:
            raise ValueError(
                f"unknown anomaly rule {rule!r} (known: {', '.join(RULES)})")
        if rule in out:
            raise ValueError(f"rule {rule!r} mapped twice in {spec!r}")
        parts = rest.split(":")
        action = parts[0].strip()
        if action not in ACTIONS:
            raise ValueError(
                f"unknown recovery action {action!r} for rule {rule!r} "
                f"(known: {', '.join(ACTIONS)})")
        try:
            budget = (int(parts[1]) if len(parts) > 1 and parts[1]
                      else _DEFAULT_BUDGET[action])
            param = (float(parts[2]) if len(parts) > 2 and parts[2]
                     else _DEFAULT_PARAM[action])
        except ValueError:
            raise ValueError(
                f"recovery rule {frag!r}: budget must be int, param "
                "float") from None
        if len(parts) > 3:
            raise ValueError(f"recovery rule {frag!r} has extra ':' parts")
        if budget < 1:
            raise ValueError(f"recovery rule {frag!r}: budget must be >= 1")
        out[rule] = ActionSpec(rule=rule, action=action, budget=budget,
                               param=param)
    if not out:
        raise ValueError(f"empty recovery policy {spec!r}")
    return out


def describe_policy(spec: Optional[str]) -> str:
    """One-line human description for the dist_trainer startup print."""
    if not spec:
        return "none (anomalies halt per --obs-halt-on)"
    return "  ".join(s.describe() for s in parse_policy(spec).values())


class RecoveryManager:
    """Budget accounting + the claim/apply handshake with the trainer.

    claim() runs inside AnomalyMonitor._emit (synchronously, before the
    halt decision); apply happens later in the same trainer iteration
    via pop_pending(). A claim is refused (-> normal halt semantics)
    when the rule is unmapped or its budget is exhausted."""

    def __init__(self, policy: Dict[str, ActionSpec], metrics=None,
                 logger=None):
        self.policy = dict(policy)
        self.metrics = metrics
        self.logger = logger
        self.pending: List[Tuple[Dict[str, Any], ActionSpec]] = []
        self.consecutive_skips = 0
        self.rollback_uses: Dict[str, int] = {}
        self.degrade_episodes = 0
        self.degraded = False
        self.n_recoveries = 0
        self.actions: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- claim
    def budget_left(self, spec: ActionSpec) -> int:
        if spec.action == "skip":
            return spec.budget - self.consecutive_skips
        if spec.action == "rollback":
            return spec.budget - self.rollback_uses.get(spec.rule, 0)
        return spec.budget - self.degrade_episodes

    def claim(self, event: Dict[str, Any]) -> bool:
        """AnomalyMonitor.recovery hook: True suppresses the halt and
        queues the action for the trainer's apply phase."""
        spec = self.policy.get(str(event.get("rule")))
        if spec is None:
            return False
        if self.budget_left(spec) <= 0:
            if self.logger is not None:
                self.logger.error(
                    "recovery: %s budget exhausted for rule %s — "
                    "declining claim (halt semantics apply)",
                    spec.action, spec.rule)
            return False
        if spec.action == "degrade" and self.degraded:
            # Already on the dense fallback; nothing further to do, but
            # the claim stands (the degraded run is the recovery).
            return True
        self.pending.append((dict(event), spec))
        return True

    def pop_pending(self) -> List[Tuple[Dict[str, Any], ActionSpec]]:
        out, self.pending = self.pending, []
        return out

    def note_ok(self) -> None:
        """A step was observed clean: transient-fault counters reset."""
        self.consecutive_skips = 0

    # ------------------------------------------------------------ record
    def record(self, action: str, step: int, rule: Optional[str] = None,
               **extra: Any) -> None:
        """Log one recovery action (fsync'd — the run may die on the
        very next step, and the action taken IS the diagnosis)."""
        rec = {"action": action, "step": step, **extra}
        if rule is not None:
            rec["rule"] = rule
        self.actions.append(rec)
        self.n_recoveries += 1
        if self.logger is not None:
            self.logger.warning("recovery: %s at step %d (%s)",
                                action, step, rule or "-")
        if self.metrics is not None:
            self.metrics.log("recovery", flush=True, **rec)
