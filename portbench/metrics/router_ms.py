"""router_ms: device ms a step of the work launched inside the program's
"router" ranges, forward and backward (a sparse-expert language model's
router: the scores, the selection, the balance loss, the sort, the
offsets, the gather and the combine); None where the stretch holds none."""

from portbench.metrics._common import device_ms

RANGES = ("router",)


def read(ctx):
    return device_ms(ctx, "router")
