"""95th percentile of the batches answered in the window: from the moment
the pipeline took a batch's host array until its streams were yielded."""

import numpy as np


def read(ctx):
    done = ctx.done()
    if ctx.kind != "encode" or not done:
        return None
    return float(np.percentile([(b.t_out - b.t_in) * 1e3 for b in done], 95))
