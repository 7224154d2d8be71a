"""Seconds from the process's start to the first timed batch: imports, the
build on a checkout's first run, the pool, the program's warm-up batches."""


def read(ctx):
    return ctx.setup_s
