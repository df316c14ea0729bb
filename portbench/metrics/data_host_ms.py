"""data_host_ms: host ms a step inside the trainer's "data" range (the
next host batch from the prefetcher, its pinned copy to the card)."""

from portbench.metrics._common import host_ms


def read(ctx):
    return host_ms(ctx, "data")
