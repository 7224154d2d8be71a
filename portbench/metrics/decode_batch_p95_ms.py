"""95th percentile of the decode pipeline's batch times (taken to answered,
as encode_batch_p95_ms counts them), over the window's batches that the
traced part did not overlap."""

import numpy as np


def read(ctx):
    if ctx.kind != "decode":
        return None
    a, b = ctx.traced or (float("inf"), float("inf"))
    times = [(x.t_out - x.t_in) * 1e3 for x in ctx.done() if x.t_out < a or x.t_in > b]
    return float(np.percentile(times, 95)) if times else None
