"""Input megapixels whose streams reached the host as bytes before the
window's end, over the window's seconds."""


def read(ctx):
    if ctx.kind != "encode":
        return None
    return sum(b.pixels for b in ctx.done()) / 1e6 / ctx.window_s
