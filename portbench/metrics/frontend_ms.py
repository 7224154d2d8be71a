"""CUDA events around the front end (color transform, chroma area pool,
pad, patches) on one batch; median of the stage runs after the traced part."""


def read(ctx):
    return ctx.stages.get("frontend_ms")
