"""graftlint for the port: stdlib-``ast`` static analysis of
``gtopkssgd_tpu_torch``'s load-bearing conventions, the port of
``gtopkssgd_tpu/analysis`` with the same six rules under the same names.

Nothing on the port's hot path (what a CUDA graph captures, the
optimizer's ``step``) may force a host sync; every ``.log(`` kind must
be registered in ``utils.metrics.KINDS``; every process exit code must
come from the ``gtopkssgd_tpu_torch.exit_codes`` registry; every sparse
(vals, idx) exchange in ``parallel/`` must flow through the wire codec;
durable record kinds must be fsynced; every anomaly rule name must be in
``obs.events.RULES``. graftlint checks all of them from source alone:
it imports neither ``torch`` nor the JAX package, needs no card and runs
in seconds.

Usage::

    python -m gtopkssgd_tpu_torch.analysis [paths ...]
        [--json] [--baseline PATH] [--no-baseline]
        [--write-baseline PATH] [--rule RULE ...] [--list-rules]

With no paths it scans ``gtopkssgd_tpu_torch/``. Exit codes (registered
in ``gtopkssgd_tpu_torch.exit_codes``): 0 = clean (every finding
suppressed or baselined), 1 = non-baselined findings, 2 = usage.

Suppressions: append ``# graftlint: disable=RULE[,RULE|all]`` to the
flagged line (or the line directly above it). Suppressions are for
reviewed deliberate cases — say why in the same comment.

Baseline: grandfathered findings live in ``baseline.json`` beside this
module (the default, found from any working directory); entries match
on (rule, path, enclosing function, flagged source) so they survive line
drift. ``--write-baseline`` regenerates it; review the diff like code.
"""

from gtopkssgd_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    analyze,
    load_baseline,
    run,
)
from gtopkssgd_tpu_torch.analysis.rules import ALL_RULES  # noqa: F401

__all__ = ["Finding", "analyze", "load_baseline", "run", "ALL_RULES"]
