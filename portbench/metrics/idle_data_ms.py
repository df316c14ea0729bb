"""idle_data_ms: ms a step in which the card sat idle while the host
staged the next dispatch (the trainer's "data" span): the median over
the run's dispatches of the program's own device-clock split
(``obs.tracing.idle``); None where the program keeps none."""

from portbench.metrics._idle import median_ms


def read(ctx):
    return median_ms(1)
