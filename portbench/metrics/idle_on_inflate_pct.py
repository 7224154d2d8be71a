"""Share of the traced part in which the card idled while the decode
pipeline's calling thread waited for the next batch's inflate
(`lrf.decode.inflate_wait`), in percent."""

from portbench.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "decode", "lrf.decode.inflate_wait")
