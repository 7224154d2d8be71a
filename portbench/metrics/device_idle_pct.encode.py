"""Share of the traced part in which no kernel or copy ran, in percent;
the mean over the cards of a data mesh. Moves encode_mpix_s."""


def read(ctx):
    t = ctx.trace
    if ctx.kind != "encode" or t is None or not t.busy_s or not any(t.busy_s.values()):
        return None
    return sum(t.idle_pct(d) for d in t.busy_s) / len(t.busy_s)
