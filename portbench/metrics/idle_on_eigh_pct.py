"""Share of the traced part in which the card idled while the pipeline's
calling thread ran the init's host `?syevd` batch (`lrf.encode.init.eigh`),
in percent."""

from portbench.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "encode", "lrf.encode.init.eigh")
