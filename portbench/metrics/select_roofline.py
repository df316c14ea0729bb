"""select_roofline: the least time of the selection's work over the
device time of the work launched inside the optimizer's "select" ranges,
in %. The work is counted from N and k alone (``yardstick.select_bytes``:
12 N + 8 k bytes) over the card's HBM rate."""

from portbench import yardstick
from portbench.metrics._common import device_ms


def read(ctx):
    t = device_ms(ctx, "select")
    if t is None or not ctx.peak_bytes:
        return None
    least_ms = 1e3 * yardstick.select_bytes(ctx.n, ctx.k) / ctx.peak_bytes
    return 100.0 * least_ms / t
