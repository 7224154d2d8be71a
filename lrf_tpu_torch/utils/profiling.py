"""Tracing, the port's span recorder, and fenced benchmarking: port of
`lrf_tpu/utils/profiling.py`.

- `trace(log_dir)`: `torch.profiler` over the enclosed block, host and (on
  a card) CUDA activity, written as a Chrome trace into `log_dir`, with the
  recorder's spans of every thread (the pipelines' serializer and inflate
  workers, a data mesh's rows) laid on the trace's own clock, one row per
  thread;
- `annotate(name)`: a labelled range: a span of the recorder, and a
  `torch.profiler.record_function` on a thread that runs the profiler;
- `device_benchmark(fn, *args)`: warm-up runs, then repeats each fenced by
  `torch.cuda.synchronize()` when a card is present; mean, spread and best
  ms, and Mpixel/s when given the pixel count.

The recorder. The pipelines (`parallel/encode.py`, `parallel/decode.py`)
record a span at each layer boundary: its name and thread, start and end
on `time.perf_counter_ns()`, the span that caused it (across threads too:
a serializer span's parent is the batch that submitted it), the batch's
sequence number in its pipeline call, bytes in and out where the
boundary moves data, and a launch's or a copy's attributes (`attrs`).
The spans of one pipeline call:

| Span | What it covers | Bytes |
| --- | --- | --- |
| `lrf.encode.batch` | root: from taking a batch to submitting its fetched factors | |
| `lrf.encode.upload` | the input batch to the device; `attrs`: `pinned` (copied into a page-locked staging block, whose copy to the card is enqueued, not pageable) | in: the batch |
| `lrf.encode.frontend` | color, chroma pool, pad, patchify: host time to enqueue | |
| `lrf.encode.gram` | the exact shared init's Grams enqueued and their copy to the host started (the encoder's `start`, a batch ahead of its init) | |
| `lrf.encode.init` | the init of every stack: from the wait for the Grams where `lrf.encode.gram` started them, else from forming them | |
| `lrf.encode.init.gram_fetch` | the Grams to the host: the wait for their copy (`attrs`: `ready`, it had ended before the wait), or the copy and its wait | in: the Grams |
| `lrf.encode.init.eigh` | the host `?syevd` batch alone | in: the Grams |
| `lrf.encode.bcd` | the BCD runs (host time to enqueue) | |
| `lrf.encode.bcd.launch` | one BCD dispatch (`ops/bcd_kernel.py::bcd`); `attrs`: `route` (`bcd_cluster`, `bcd_cluster_wide`, `bcd_grid`, `bcd`, or `reference` for the plain version on the CPU) and `shape` `(B, M, N, R)` | |
| `lrf.encode.deflate` | the card's zlib-9 of the fibers enqueued (`ops/deflate.py`; raw int8 factors under a zlib-9 coder on a card) | in: the factors; out: the streams, once fetched |
| `lrf.encode.deflate.launch` | one DEFLATE launch (`deflate_fibers`); `attrs`: `M` and `fibers` | in: the launch's fibers |
| `lrf.encode.fetch_start` | the factors' (or the card's streams') device -> pinned-host copy started | in: the buffers |
| `lrf.encode.fetch_wait` | the wait for that copy | |
| `lrf.encode.serializer_queue` | submit to a serializer worker's start (worker) | |
| `lrf.encode.serialize` | the native serializer (worker) | in: factors; out: streams |
| `lrf.encode.result_wait` | the calling thread's wait for a batch's streams | |
| `lrf.decode.batch` | root: from taking a batch of streams to its pixels | |
| `lrf.decode.inflate` | parse, native inflate and pack (worker) | in: streams; out: upload |
| `lrf.decode.parse` | its container parse, Python that holds the GIL (worker) | |
| `lrf.decode.inflate_wait` | the calling thread's wait for the inflate | |
| `lrf.decode.device` | from the upload until its pixels are on the host (`begin`/`end`: in the pipeline it stays open while the next batch is enqueued) | |
| `lrf.decode.upload` / `.reconstruct` | the upload; the reconstruction, ending in the pixels' copy to page-locked memory (enqueued) | upload in |
| `lrf.decode.to_host` | the calling thread's wait for that copy; `attrs`: `pinned` (a page-locked copy, not CPU pixels taken as they are) and `ready` (the copy had ended before the wait) | in: the pixels |
| `lrf.mesh.row` | one data row's work on its own thread (`Mesh.map_rows`) | |

A span on the thread of its parent lies inside it, and so does one on a
mesh row; a worker's span starts once its parent submitted it, and may end
after it. The front end and the BCD enqueue device work, so their spans
time the host, not the card.

Nothing records unless a profiler runs: each pipeline entry, each batch
taken and each answer (and `trace`, `annotate`) reads
`torch.autograd._profiler_enabled()` on its own thread, which sets one
process-wide flag that the workers read; a span records if the flag is on
when it starts. Untraced runs pay one branch per span and two checks per
batch. The spans marked as waits or host
work (`init.eigh`, `fetch_wait`, `result_wait`, `inflate_wait`) also
enter `record_function` under their name on a thread whose profiler runs,
so the profiler names the card's idle gaps after them; no span that
encloses a launch or a copy does, so none shows on the device's timeline.
The spans stay in a bounded buffer (`CAPACITY`), read by `snapshot()`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "Span", "trace", "annotate", "device_benchmark", "span", "begin", "end", "within", "record", "current",
    "follow_profiler", "snapshot", "profiler_us",
]

CAPACITY = 1 << 16  # spans kept; the oldest go first


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span; times are `time.perf_counter_ns()`."""

    name: str
    id: int
    parent: Optional[int]  # the id of the span that caused it
    batch: Optional[int]  # the batch's sequence number in its pipeline call
    thread: int  # native thread id, the profiler's `tid`
    thread_name: str
    start_ns: int
    end_ns: int = -1
    bytes_in: Optional[int] = None
    bytes_out: Optional[int] = None
    row: Optional[int] = None  # a data mesh's row
    mirrored: bool = False  # also a `record_function` in the profiler
    attrs: Optional[dict] = None  # route and shape (BCD), M and fibers (DEFLATE), pinned and ready (copies)


class _Recorder:
    def __init__(self, capacity: int):
        self.on = False
        self.anchor = (time.perf_counter_ns(), time.time_ns())  # taken again whenever it comes on
        self._spans: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def new(self, name, parent, batch, bytes_in, row, start_ns=None) -> Span:
        if parent is None:
            stack = self.stack()
            parent = stack[-1] if stack else None
        if batch is None and parent is not None:
            batch = parent.batch
        t = threading.current_thread()
        return Span(name, next(self._ids), parent.id if parent is not None else None, batch,
                    t.native_id, t.name, time.perf_counter_ns() if start_ns is None else start_ns,
                    bytes_in=bytes_in, row=row)

    def keep(self, s: Span) -> None:
        with self._lock:
            self._spans.append(s)

    def snapshot(self, clear: bool) -> list:
        with self._lock:
            out = list(self._spans)
            if clear:
                self._spans.clear()
        return out


_REC = _Recorder(CAPACITY)


def follow_profiler() -> bool:
    """Recording on while a profiler runs on the calling thread, off when
    none does; the pipelines call it at entry and at each batch."""
    on = torch.autograd._profiler_enabled()
    if on and not _REC.on:
        _REC.anchor = (time.perf_counter_ns(), time.time_ns())
    _REC.on = on
    return on


class _Off:
    """What `span` and `within` return while nothing records."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Scope:
    __slots__ = ("_args", "_mirror", "_span", "_rf")

    def __init__(self, args, mirror):
        self._args = args
        self._mirror = mirror
        self._rf = None

    def __enter__(self) -> Span:
        rf = None
        if self._mirror and torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function(self._args[0])
        s = self._span = _REC.new(*self._args)
        if rf is not None:
            s.mirrored = True
            self._rf = rf
            s.start_ns = time.perf_counter_ns()  # next to the profiler's own stamp
            rf.__enter__()
        _REC.stack().append(s)
        return s

    def __exit__(self, *exc):
        s = self._span
        if self._rf is not None:
            self._rf.__exit__(*exc)
        s.end_ns = time.perf_counter_ns()  # a mirror's range lies inside the span's
        _REC.stack().pop()
        _REC.keep(s)
        return False


def span(name: str, *, parent: Optional[Span] = None, batch: Optional[int] = None,
         bytes_in: Optional[int] = None, row: Optional[int] = None, mirror: bool = False):
    """A span over the enclosed block, yielding the `Span` (None while
    nothing records), the thread's current span inside it. `parent`
    defaults to the thread's current span and `batch` to the parent's.
    `mirror`: also a `record_function` where the profiler runs on this
    thread; only for a block that launches no kernel and makes no copy."""
    if not _REC.on:
        return _OFF
    return _Scope((name, parent, batch, bytes_in, row), mirror)


def begin(name: str, *, batch: Optional[int] = None) -> Optional[Span]:
    """Open a span that `end` closes, possibly after others opened on the
    thread (a pipeline's batch); it is not the thread's current span (see
    `within`). None while nothing records."""
    if not _REC.on:
        return None
    return _REC.new(name, None, batch, None, None)


def end(s: Optional[Span]) -> None:
    if s is not None:
        s.end_ns = time.perf_counter_ns()
        _REC.keep(s)


def within(s: Optional[Span]):
    """Make `s` the current span of this thread over the enclosed block, so
    the spans opened there are its children (on a worker, a mesh row, or
    the pipeline's thread between batches)."""
    if s is None:
        return _OFF
    return _Within(s)


class _Within:
    __slots__ = ("_span",)

    def __init__(self, s):
        self._span = s

    def __enter__(self) -> Span:
        _REC.stack().append(self._span)
        return self._span

    def __exit__(self, *exc):
        _REC.stack().pop()
        return False


def record(name: str, start_ns: int, end_ns: Optional[int] = None, *, parent: Optional[Span] = None) -> None:
    """A span already over, from `start_ns` to `end_ns` (default now), on
    this thread: a wait that began elsewhere, such as a queue's."""
    if not _REC.on:
        return
    s = _REC.new(name, parent, None, None, None, start_ns)
    s.end_ns = time.perf_counter_ns() if end_ns is None else end_ns
    _REC.keep(s)


def current() -> Optional[Span]:
    """This thread's innermost open span, or None."""
    stack = _REC.stack() if _REC.on else ()
    return stack[-1] if stack else None


def snapshot(clear: bool = False) -> list:
    """The finished spans in the buffer, oldest first; `clear` empties it."""
    return _REC.snapshot(clear)


def profiler_us(ns: int, trace_start_ns: int) -> float:
    """A `perf_counter_ns` time on a profiler's clock: microseconds after
    its `trace_start_ns`, as `prof.events()` give their `time_range`."""
    perf, wall = _REC.anchor
    return (ns - perf + wall - trace_start_ns) / 1e3


def _trace_start_ns(prof) -> int:
    results = prof.profiler.kineto_results
    if hasattr(results, "trace_start_ns"):
        return results.trace_start_ns()
    return results.trace_start_us() * 1000


def _chrome_events(spans, trace_start_ns: int, base_ns: int, pid: int) -> list:
    """The spans as Chrome trace events, whose `ts` are microseconds after
    `base_ns`: complete events on their thread's row where they nest, async
    ones where they overlap a sibling (a pipeline's batches, a worker's
    queue waits)."""
    offset_us = (trace_start_ns - base_ns) / 1e3
    out, named = [], {}
    for tid in {s.thread for s in spans}:
        stack = []
        for s in sorted((s for s in spans if s.thread == tid), key=lambda s: (s.start_ns, -s.end_ns)):
            named.setdefault(tid, s.thread_name)
            while stack and stack[-1].end_ns <= s.start_ns:
                stack.pop()
            args = {k: v for k, v in (("id", s.id), ("parent", s.parent), ("batch", s.batch), ("row", s.row),
                                       ("bytes_in", s.bytes_in), ("bytes_out", s.bytes_out)) if v is not None}
            args.update(s.attrs or {})
            ts = profiler_us(s.start_ns, trace_start_ns) + offset_us
            ev = {"name": s.name, "cat": "lrf", "pid": pid, "tid": tid, "ts": ts, "args": args}
            if stack and s.end_ns > stack[-1].end_ns:
                out.append({**ev, "ph": "b", "id": s.id})
                out.append({**ev, "ph": "e", "id": s.id, "ts": ts + (s.end_ns - s.start_ns) / 1e3, "args": {}})
            else:
                out.append({**ev, "ph": "X", "dur": (s.end_ns - s.start_ns) / 1e3})
                stack.append(s)
    out += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": name}}
            for tid, name in named.items()]
    return out


def _add_spans(path: str, spans, trace_start_ns: int) -> None:
    with open(path) as f:
        doc = json.load(f)
    known = {e.get("tid") for e in doc["traceEvents"] if e.get("ph") == "M" and e.get("name") == "thread_name"}
    events = [e for e in _chrome_events(spans, trace_start_ns, int(doc.get("baseTimeNanoseconds", 0)), os.getpid())
              if not (e["ph"] == "M" and e["tid"] in known)]
    doc["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block; yields the `torch.profiler.profile`
    (its `key_averages()` sums time by op and kernel). On exit the Chrome
    trace is written to `log_dir` (default: `lrf_tpu_torch_trace` under
    the temporary directory) as `trace_<pid>_<n>.json`, with the
    recorder's spans that started in the block."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "lrf_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    try:
        with profile(activities=activities) as prof:
            follow_profiler()
            t0 = time.perf_counter_ns()
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        follow_profiler()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(path)
    spans = [s for s in snapshot() if s.start_ns >= t0 and not s.mirrored]
    if spans:
        _add_spans(path, spans, _trace_start_ns(prof))


def annotate(name: str):
    """Label a region: a span of the recorder, and a `record_function` in
    the profile where one runs on this thread."""
    if torch.autograd._profiler_enabled() and not _REC.on:
        follow_profiler()
    return span(name, mirror=True)


def device_benchmark(fn: Callable, *args, warmup: int = 2, repeats: int = 10, pixels: Optional[int] = None) -> dict:
    """Time `fn(*args)`: `warmup` runs (builds and caches included), then
    `repeats` runs on the host clock, each started and ended with the card
    idle. Returns `mean_ms`, `std_ms`, `min_ms`, and `mpixels_per_s` when
    `pixels` is given."""
    fence = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    for _ in range(warmup):
        fn(*args)
    fence()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        fence()
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    out = {"mean_ms": float(times.mean() * 1e3), "std_ms": float(times.std() * 1e3), "min_ms": float(times.min() * 1e3)}
    if pixels is not None:
        out["mpixels_per_s"] = float(pixels / times.mean() / 1e6)
    return out
