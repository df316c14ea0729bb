"""idle_tail_ms: ms a step in which the card sat idle between dispatches
while the host was not staging: the previous dispatch's read and
bookkeeping and the caller's time between ``train`` calls. The median
over the run's dispatches of the program's own device-clock split
(``obs.tracing.idle``); None where the program keeps none."""

from portbench.metrics._idle import median_ms


def read(ctx):
    return median_ms(2)
