"""Output megapixels delivered to the host as uint8 arrays before the
window's end, over the window's seconds."""


def read(ctx):
    if ctx.kind != "decode":
        return None
    return sum(b.pixels for b in ctx.done()) / 1e6 / ctx.window_s
