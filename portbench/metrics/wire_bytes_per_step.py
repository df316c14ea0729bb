"""wire_bytes_per_step: the bytes this rank shipped in the gradient
exchange a step over the window, from the port's counter
``parallel.collectives.wire["bytes"]``; None where nothing was shipped
(P = 1)."""


def read(ctx):
    v = ctx.wire_bytes_per_step
    return v if ctx.chips > 1 and v else None
