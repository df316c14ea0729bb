"""attention_ms: device ms a step of the work launched inside the program's
"attention" ranges, forward and backward (a sparse-expert language model's
multi-head latent attention: its projections, RoPE, the attention
and the output projection); None where the stretch holds none."""

from portbench.metrics._common import device_ms

RANGES = ("attention",)


def read(ctx):
    return device_ms(ctx, "attention")
