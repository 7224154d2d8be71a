"""Host clock around `parallel/decode.py::_device_decode` (upload,
reconstruction, pixels to the host) for one batch, ending in a device
synchronization; median of the stage runs."""


def read(ctx):
    return ctx.stages.get("decode_device_ms")
