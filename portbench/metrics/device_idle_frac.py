"""device_idle_frac: the share of a step in which no work of the rank's
own ran on its card, in %: one less the device's busy time a step in the
profiled stretch (its work's own durations) over the wall time a step of
the window outside that stretch (``portbench/trace.py`` says why)."""


def read(ctx):
    tr = ctx.trace
    if not tr.get("steps") or not tr.get("busy_s") or not ctx.rate_outside:
        return None
    busy_per_step = tr["busy_s"] / tr["steps"]
    return 100.0 * (1.0 - busy_per_step * ctx.rate_outside)
