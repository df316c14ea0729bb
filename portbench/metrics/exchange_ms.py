"""exchange_ms: device ms a step of the work launched inside the
optimizer's "exchange" range, NCCL's kernels included (they hold the
wait for the slowest rank); None where no exchange ran (P = 1)."""

from portbench.metrics._common import device_ms


def read(ctx):
    if ctx.chips < 2:
        return None
    return device_ms(ctx, "exchange")
