"""Host clock around `parallel/decode.py::_inflate_streams` (parse, native
inflate, upload pack) for one batch; median of the stage runs."""


def read(ctx):
    return ctx.stages.get("decode_host_ms")
