"""Bits per pixel of the window: 8 x the stream bytes of the batches
answered in the window over their input pixels."""


def read(ctx):
    done = ctx.done()
    if ctx.kind != "encode" or not done:
        return None
    return 8.0 * sum(b.nbytes for b in done) / sum(b.pixels for b in done)
