"""Median of the traced part's `lrf.encode.serializer_queue` spans: from a
batch's submit to the serializer pool until a worker starts it."""

from portbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, "encode", "lrf.encode.serializer_queue")
