"""The program's own spans (`lrf_tpu_torch/utils/profiling.py`) for the span
metrics: those that started inside a run's traced part, read from the
program's recorder after the window. A program that keeps no spans gives
every reader nothing to read, and the reader returns None."""

from __future__ import annotations

import statistics


def traced(ctx, name: str):
    """The spans named `name` that started inside the traced part, or None
    where the run was not traced or the program records no spans."""
    if ctx.trace is None or ctx.traced is None:
        return None
    try:
        from lrf_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    a, b = ctx.traced[0] * 1e9, ctx.traced[1] * 1e9  # perf_counter seconds -> perf_counter_ns
    return [s for s in snapshot() if s.name == name and a <= s.start_ns <= b]


def median_ms(ctx, kind: str, name: str):
    """Median duration in ms of the traced part's `name` spans in a cell of
    `kind` ("encode" or "decode")."""
    spans = traced(ctx, name) if ctx.kind == kind else None
    if not spans:
        return None
    return statistics.median((s.end_ns - s.start_ns) / 1e6 for s in spans)


def idle_pct(ctx, kind: str, name: str):
    """Share of the traced part, in percent, in which the first card ran no
    kernel or copy while the pipeline's calling thread was inside a `name`
    span (the profiler's mirror of it: `trace.Summary.idle_by_host`)."""
    if ctx.kind != kind or not traced(ctx, name):
        return None
    return 100.0 * ctx.trace.idle_by_host.get(name, 0.0) / ctx.trace.window_s
