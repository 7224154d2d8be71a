"""The BCD kernels' share of their roofline in the traced part, in percent:
the least time of the launched shapes (`roofline.bcd_bound_ms`, from the
cell's shapes and the launches `KERNEL.counts` counted) over the device
time of the kernels named `bcd*` in the profile."""

from portbench.roofline import bcd_bound_ms


def read(ctx):
    t = ctx.trace
    if ctx.kind != "encode" or t is None or not ctx.bcd_launches or not ctx.launch_shapes:
        return None
    kernel_s = sum(s for name, s in t.kernels if "bcd" in name)
    if kernel_s <= 0:
        return None
    iters = ctx.config["num_iters"]
    per_batch_ms = sum(bcd_bound_ms(*shape, iters)[0] for shape in ctx.launch_shapes)
    batches = ctx.bcd_launches / len(ctx.launch_shapes)
    return 100.0 * batches * per_batch_ms / 1e3 / kernel_s
