"""optimizer_ms: device ms a step of the work launched inside the
trainer's "optimizer" range (ravel, selection, residual, exchange,
scatter, SGD)."""

from portbench.metrics._common import device_ms


def read(ctx):
    return device_ms(ctx, "optimizer")
