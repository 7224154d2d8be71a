"""Share of the traced part in which the card idled while the pipeline's
calling thread waited for a batch's streams from the serializer workers
(`lrf.encode.result_wait`), in percent."""

from portbench.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "encode", "lrf.encode.result_wait")
