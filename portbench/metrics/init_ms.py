"""Host clock around `ops/bcd.py::svd_init_shared` on one batch's Y and
merged Cb+Cr stacks, ending in a device synchronization; median of the
stage runs after the traced part."""


def read(ctx):
    return ctx.stages.get("init_ms")
