"""fb_ms: device ms a step of the work launched inside the trainer's
"forward_backward" range (the model's forward and backward)."""

from portbench.metrics._common import device_ms


def read(ctx):
    return device_ms(ctx, "forward_backward")
