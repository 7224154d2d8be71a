"""The idlest card's share of the traced part with no kernel or copy, in
percent, on a data mesh of several cards."""


def read(ctx):
    t = ctx.trace
    if t is None or len(t.busy_s) < 2 or not any(t.busy_s.values()):
        return None
    return max(t.idle_pct(d) for d in t.busy_s)
