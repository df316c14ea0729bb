"""experts_ms: device ms a step of the work launched inside the program's
"experts" ranges, forward and backward (a sparse-expert language model's
held experts: the grouped products); None where the stretch holds none."""

from portbench.metrics._common import device_ms

RANGES = ("experts",)


def read(ctx):
    return device_ms(ctx, "experts")
