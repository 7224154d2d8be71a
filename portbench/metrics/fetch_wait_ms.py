"""Median of the traced part's `lrf.encode.fetch_wait` spans: the calling
thread's wait for a batch's factors to land in pinned host memory."""

from portbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, "encode", "lrf.encode.fetch_wait")
