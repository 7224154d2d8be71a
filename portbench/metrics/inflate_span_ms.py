"""Median of the traced part's `lrf.decode.inflate` spans: one batch's
parse, native inflate and pack on the worker, under the window's load."""

from portbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, "decode", "lrf.decode.inflate")
