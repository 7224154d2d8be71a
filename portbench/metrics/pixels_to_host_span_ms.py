"""Median of the traced part's `lrf.decode.to_host` spans: one batch's pixels
to host memory, with the wait for the reconstruction the copy implies."""

from portbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, "decode", "lrf.decode.to_host")
