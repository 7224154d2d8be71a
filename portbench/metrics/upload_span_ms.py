"""Median of the traced part's `lrf.encode.upload` spans: one input batch's
pageable copy to the card."""

from portbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, "encode", "lrf.encode.upload")
