"""Resilience for long synchronous runs, the port of
``gtopkssgd_tpu/resilience``:

  preempt.py  ``PreemptionGuard`` (SIGTERM/SIGINT set a flag; the trainer
              saves at the next dispatch boundary and exits 45) and
              ``retry_call``.
  inject.py   ``--inject SPEC``: deterministic, step-keyed faults
              (``nan_grad``, ``slow_rank``, ``loader_raise``, ``preempt``,
              ``corrupt_ckpt``, ``reshape``, ``resize``, ``evict_rank``),
              each firing an "inject" record.
  elastic.py  ``--elastic``: a resize drains, saves, rewrites the
              ``elastic.json`` lineage and exits 46; the relaunch at the
              new P re-partitions the residual (grow: zero rows; shrink:
              rows folded by addition, column sums kept).
  policy.py   ``--recover-policy``: anomaly rules (``obs.events``) mapped
              to skip, rollback or degrade; ``RecoveryManager`` claims an
              event before it halts and the trainer applies the action.

Checkpoint integrity (config hash and state digest sidecars, the torn-step
fallback) lives in ``utils/checkpoint.py``.
"""

from gtopkssgd_tpu_torch.resilience.elastic import (
    ResizeRestart,
    load_lineage,
    mint_lineage_id,
    repartition_buffer,
    repartition_residual,
    source_rows,
    surviving_ranks,
    write_lineage,
)
from gtopkssgd_tpu_torch.resilience.inject import (
    Fault,
    FaultInjector,
    InjectedLoaderError,
    corrupt_checkpoint_dir,
    parse_inject,
)
from gtopkssgd_tpu_torch.resilience.policy import (
    ActionSpec,
    RecoveryManager,
    describe_policy,
    parse_policy,
)
from gtopkssgd_tpu_torch.resilience.preempt import (
    PREEMPT_EXIT_CODE,
    Preempted,
    PreemptionGuard,
    retry_call,
)

__all__ = [
    "PREEMPT_EXIT_CODE",
    "ActionSpec",
    "RecoveryManager",
    "Fault",
    "FaultInjector",
    "InjectedLoaderError",
    "Preempted",
    "PreemptionGuard",
    "ResizeRestart",
    "corrupt_checkpoint_dir",
    "describe_policy",
    "load_lineage",
    "mint_lineage_id",
    "parse_inject",
    "parse_policy",
    "repartition_buffer",
    "repartition_residual",
    "retry_call",
    "source_rows",
    "surviving_ranks",
    "write_lineage",
]
