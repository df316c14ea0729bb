"""mfu: the model's FLOPs a step (``yardstick.step_flops``, counted from
the configuration's shapes) times the steps a second of the window
outside the profiled stretch, over the card's published dense peak for
the configuration's compute dtype, in %."""


def read(ctx):
    if not ctx.peak_flops or not ctx.rate_outside:
        return None
    return 100.0 * ctx.flops_per_step * ctx.rate_outside / ctx.peak_flops
