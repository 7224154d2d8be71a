"""Device milliseconds of the card's DEFLATE a batch in the traced part: the
profile's seconds of `deflate_fibers_kernel` over the batches with a
`lrf.encode.deflate.launch` span (`lrf_tpu_torch/ops/deflate.py`) started in
it, a batch being the launches' parent `lrf.encode.deflate` span. Its share
of a roofline is left out on purpose: the kernel's bound is the slowest
fiber's serial parse, not bytes or flops. Nothing to read where the program
records no DEFLATE launch."""

from portbench.spans import traced


def read(ctx):
    if ctx.kind != "encode":
        return None
    launches = traced(ctx, "lrf.encode.deflate.launch")
    if not launches:
        return None
    kernel_s = sum(sec for name, sec in ctx.trace.kernels if "deflate_fibers_kernel" in name)
    return 1e3 * kernel_s / len({s.parent for s in launches})
