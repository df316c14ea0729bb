"""sgd_ms: device ms a step of the work launched inside the optimizer's
"sgd" range: SGD's step from the flat update (weight decay, momentum, the
parameters and momentum buffers written); None where the stretch holds
none, as in a program without that range."""

from portbench.metrics._common import device_ms

RANGES = ("sgd",)


def read(ctx):
    return device_ms(ctx, "sgd")
