"""Host clock around `parallel/encode.py::_serialize_batch` on one batch's
fetched factors (per-fiber DEFLATE and framing in the native coder);
median of the stage runs after the traced part."""


def read(ctx):
    return ctx.stages.get("serialize_ms")
