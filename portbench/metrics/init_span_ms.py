"""Median of the traced part's `lrf.encode.init` spans: the init of one
batch's stacks on the host clock, the Grams' fetch and the host eigh
included."""

from portbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, "encode", "lrf.encode.init")
