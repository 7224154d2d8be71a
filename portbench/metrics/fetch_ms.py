"""Host clock around `HostCopy` of one batch's encoded output to pinned host
memory and its wait (`parallel/encode.py::_fetch_encoded`); median of the
stage runs after the traced part."""


def read(ctx):
    return ctx.stages.get("fetch_ms")
