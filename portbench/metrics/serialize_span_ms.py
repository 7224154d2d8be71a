"""Median of the traced part's `lrf.encode.serialize` spans: one batch's
native serializer on a worker, under the window's load."""

from portbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, "encode", "lrf.encode.serialize")
