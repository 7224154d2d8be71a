"""The wide cluster kernel's share of its roofline in the traced part, in
percent: the least time (`roofline.bcd_bound_ms`) of the BCD launches whose
`lrf.encode.bcd.launch` span (`lrf_tpu_torch/ops/bcd_kernel.py`) names the
route `bcd_cluster_wide`, from the shape the span carries, over the profile's
device time of the cluster kernel's instantiations at R 17-32 (R is the
template's first argument in the kernel's name). The frozen bound reads the
same work whatever kernel runs it. Nothing to read where no wide launch was
recorded."""

import re

from portbench.roofline import bcd_bound_ms
from portbench.spans import traced

WIDE = range(17, 33)
RANK = re.compile(r"bcd_cluster_kernel<(\d+)")


def read(ctx):
    if ctx.kind != "encode":
        return None
    wide = [s for s in traced(ctx, "lrf.encode.bcd.launch") or () if s.attrs["route"] == "bcd_cluster_wide"]
    if not wide:
        return None
    kernel_s = sum(sec for name, sec in ctx.trace.kernels if (m := RANK.search(name)) and int(m.group(1)) in WIDE)
    if kernel_s <= 0:
        return None
    bound_ms = sum(bcd_bound_ms(*s.attrs["shape"], ctx.config["num_iters"])[0] for s in wide)
    return 100.0 * bound_ms / 1e3 / kernel_s
