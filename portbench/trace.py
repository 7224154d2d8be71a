"""The traced part of a window: `torch.profiler` (host and CUDA activity)
between two device synchronizations, read into per-card busy time, device
time by operation, and idle gaps named by what the host was doing."""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import torch

# The benchmark's own spans around calls into the pipeline; the host
# thread that records them is the pipeline's calling thread.
NEXT_SPAN = "portbench: next batch"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: dict  # device index -> seconds in which a kernel or copy ran
    device_s: dict  # device operation name -> seconds, all cards
    idle_by_host: dict  # host activity -> idle seconds of the first card
    kernels: list  # (name, seconds) of every device kernel, all cards

    def idle_pct(self, device: int) -> float:
        return 100.0 * (1.0 - self.busy_s[device] / self.window_s)


class Profile:
    """Start and stop the profiler around a steady part of a window."""

    def __init__(self, devices: list, counter=None):
        self.devices = [torch.device(d) for d in devices]
        self.cuda = [d for d in self.devices if d.type == "cuda"]
        self.counter = counter or (lambda: 0)  # a count to read at the edges (kernel launches)
        self.counted = 0
        self.prof = None
        self.t_start = self.t_stop = None
        self.t_begin = self.t_done = None  # around the profiler's own start and stop

    def _sync(self) -> None:
        for d in self.cuda:
            torch.cuda.synchronize(d)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.t_begin = time.perf_counter()
        self._sync()
        self.prof = profile(activities=activities)
        self.prof.start()
        self.t_start = time.perf_counter()
        self.counted = -self.counter()

    def stop(self) -> None:
        self._sync()
        self.t_stop = time.perf_counter()
        self.counted += self.counter()
        self.prof.stop()
        self.t_done = time.perf_counter()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t_stop is None

    def summary(self) -> Summary:
        window_s = self.t_stop - self.t_start
        events = list(self.prof.events())
        # the benchmark's own span is mirrored onto the device's timeline as an annotation, not work
        dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and e.name != NEXT_SPAN]
        host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        busy, intervals = {}, defaultdict(list)
        for e in dev:
            intervals[e.device_index].append((e.time_range.start, e.time_range.end))
        for d in self.cuda:
            busy[d.index] = _union_us(intervals.get(d.index, [])) / 1e6
        device_s = defaultdict(float)
        for e in dev:
            device_s[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        kernels = [(e.name, (e.time_range.end - e.time_range.start) / 1e6) for e in dev
                   if not e.name.startswith(("Memcpy", "Memset"))]
        idle = _idle_by_host(host, intervals.get(self.cuda[0].index, []) if self.cuda else [], window_s)
        return Summary(window_s, busy, dict(device_s), idle, kernels)


def _union_us(spans) -> float:
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _idle_by_host(host, spans, window_s: float) -> dict:
    """Idle seconds of one card, each gap named by the innermost host op of
    the pipeline's calling thread that covers the gap's middle."""
    calls = [e for e in host if e.name == NEXT_SPAN]
    if not calls:
        return {}
    main = calls[0].thread
    ops = [e for e in host if e.thread == main]
    t0 = min(e.time_range.start for e in ops)
    t1 = t0 + window_s * 1e6
    busy = _merged(spans)
    gaps, cur = [], t0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, min(a, t1)))
        cur = max(cur, b)
    if cur < t1:
        gaps.append((cur, t1))
    names = _innermost(ops, [(a + b) / 2 for a, b in gaps])
    out = defaultdict(float)
    for (a, b), name in zip(gaps, names):
        if b > a:
            if name == NEXT_SPAN:
                name = "pipeline call, no traced op (Python or a wait)"
            out[name] += (b - a) / 1e6
    return dict(out)


def _innermost(ops, times) -> list:
    """Per time (ascending), the name of the latest-starting op that covers
    it, by one sweep with a stack of open ops (one thread's ops nest)."""
    ops = sorted(ops, key=lambda e: (e.time_range.start, -e.time_range.end))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ops) and ops[i].time_range.start <= t:
            e = ops[i]
            while stack and stack[-1].time_range.end < e.time_range.start:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1].time_range.end < t:
            stack.pop()
        out.append(stack[-1].name if stack else "outside the pipeline's calls")
    return out
