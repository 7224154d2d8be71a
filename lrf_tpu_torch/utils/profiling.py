"""Tracing and fenced benchmarking: port of `lrf_tpu/utils/profiling.py`.

- `trace(log_dir)`: `torch.profiler` over the enclosed block, host and (on
  a card) CUDA activity, written as a Chrome trace into `log_dir`;
- `annotate(name)`: a labelled range inside such a trace
  (`torch.profiler.record_function`);
- `device_benchmark(fn, *args)`: warm-up runs, then repeats each fenced by
  `torch.cuda.synchronize()` when a card is present; mean, spread and best
  ms, and Mpixel/s when given the pixel count.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["trace", "annotate", "device_benchmark"]


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block; yields the `torch.profiler.profile`
    (its `key_averages()` sums time by op and kernel). On exit the Chrome
    trace is written to `log_dir` (default: `lrf_tpu_torch_trace` under
    the temporary directory) as `trace_<pid>_<n>.json`."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "lrf_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name: str):
    """Label a region inside profiler traces."""
    return torch.profiler.record_function(name)


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
