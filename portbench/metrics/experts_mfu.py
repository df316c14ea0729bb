"""experts_mfu: the held experts' grouped products' share of the card's
published dense peak for the configuration's compute dtype, in %: their
FLOPs a step over the device time a step in the program's "experts"
ranges.

The FLOPs are counted here, from the configuration's widths and the
program's own count of each step's (token, held expert) pairs
(``gtopkssgd_tpu_torch.obs.tracing.routing``): the mean over the steps
of the profiled stretch whose device time the metric divides by, the
last ``steps`` rows that the program marked as read under a profiler
(the stretch is the run's last profiled one). Three products a pair
(gate, up, down) of 2 x hidden x width FLOPs each, forward once and
backward twice, 18 x hidden x width a pair (``expert_flops``). A
recomputation in the program's backward is not counted. None where the
program keeps no such record, or marks fewer profiled steps than the
stretch holds."""

from __future__ import annotations

from typing import Optional

from portbench.metrics._common import device_ms

RANGES = ("experts",)


def expert_flops(hidden: int, width: int, pairs: float) -> float:
    """FLOPs of a step's expert products over `pairs` (token, expert)
    pairs: 18 x hidden x width each."""
    return 18.0 * hidden * width * pairs


def pairs_per_step(steps: int) -> Optional[float]:
    """The mean pairs a step over the last `steps` profiled steps of the
    program's record; None where it holds fewer."""
    from gtopkssgd_tpu_torch.obs import tracing

    rows = [r for r in getattr(tracing, "routing", ())
            if len(r) > 3 and r[3]]
    if steps <= 0 or len(rows) < steps:
        return None
    return sum(r[0] for r in rows[-steps:]) / steps


def read(ctx):
    t = device_ms(ctx, "experts")
    if t is None or not ctx.peak_flops:
        return None
    pairs = pairs_per_step(int(ctx.trace["steps"]))
    if not pairs:
        return None
    c = ctx.config
    flops = expert_flops(c["hidden_size"], c["moe_intermediate_size"], pairs)
    return 100.0 * flops / (t / 1e3) / ctx.peak_flops
