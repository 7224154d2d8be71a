"""Share of the traced part's batches whose fibers the card DEFLATEd, in
percent: of the `lrf.encode.serialize` spans that started in the traced
part under a recorded batch, those whose batch (the span's parent) also
has an `lrf.encode.deflate` span (`lrf_tpu_torch/ops/deflate.py`; the
serializer then only frames the card's zlib streams). A batch taken before
the recorder came on has no span, so its serialize span has no parent and
is not counted. Nothing to read where the program has no DEFLATE on the
card."""

import importlib.util

from portbench.spans import traced


def read(ctx):
    if ctx.kind != "encode" or importlib.util.find_spec("lrf_tpu_torch.ops.deflate") is None:
        return None
    serialize = [s for s in traced(ctx, "lrf.encode.serialize") or () if s.parent is not None]
    if not serialize:
        return None
    from lrf_tpu_torch.utils import profiling

    on_card = {s.parent for s in profiling.snapshot() if s.name == "lrf.encode.deflate"}
    return 100.0 * sum(s.parent in on_card for s in serialize) / len(serialize)
