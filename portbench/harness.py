"""One run of one cell: set-up, the measured window, the traced part, the
stage times, the comparison with the reference, and the result line.

The traffic is a closed loop over a pool of host batches (`mixes/*.json`):
`encode` feeds the pool round-robin into `sharded_qmf_encode_batches`,
`decode` feeds the pool's streams (encoded by the program in set-up) into
`sharded_qmf_decode_batches`. A batch's time runs from the moment the
pipeline takes it until its answer is yielded; the window's rates count the
answers yielded before the window's end, over the window's seconds.
"""

from __future__ import annotations

import dataclasses
import statistics
import subprocess
import sys
import time
from contextlib import nullcontext

import numpy as np
import torch

from portbench import images, stages
from portbench.cells import Cell
from portbench.reference import compare
from portbench.trace import NEXT_SPAN, Profile

# Top-level module names that may not be loaded in the process that prints a result.
FORBIDDEN = ("jax", "jaxlib", "flax", "lrf_tpu")
# The traced part: from this share of the window, for at most these seconds
# (and at most half the window), so that it sees the pipeline full and ends
# before the window's drain.
TRACE_FROM = 0.3
TRACE_SECONDS = 5.0
# One-batch runs of each stage after the window (their median is reported),
# and images the reference encodes at a time.
STAGE_REPS = 3
CHECK_CHUNK = 16


@dataclasses.dataclass
class Batch:
    pool_index: int
    t_in: float
    t_out: float = float("nan")
    pixels: int = 0
    nbytes: int = 0


@dataclasses.dataclass
class Context:
    """What a metric's `read(ctx)` can read."""

    kind: str  # "encode" or "decode"
    setup_s: float
    window_s: float
    t_start: float
    t_end: float
    batches: list  # Batch, in the order handed
    devices: list
    config: dict
    mix: dict
    launch_shapes: list = dataclasses.field(default_factory=list)  # (b, m, n, r) of one batch's BCD launches
    trace: object = None  # trace.Summary of the traced part
    traced: tuple = None  # the traced part with the profiler's start and stop, on the host clock
    bcd_launches: int = 0  # launches counted during the traced part
    stages: dict = dataclasses.field(default_factory=dict)

    def done(self) -> list:
        """Batches whose answer came before the window's end."""
        return [b for b in self.batches if b.t_out <= self.t_end]


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _encoder_args(cfg: dict) -> dict:
    return dict(quality=cfg["quality"], scale_factor=tuple(cfg["scale_factor"]), patch_size=tuple(cfg["patch_size"]),
                bounds=tuple(cfg["bounds"]), num_iters=cfg["num_iters"], init=cfg["init"], pack=cfg.get("pack"))


def _launch_shapes(cfg: dict, batch: int, rows: int) -> list:
    """(B, M, N, R) of the BCD launches one batch makes: per data row, the
    Y stack and the merged Cb+Cr stack."""
    from portbench.reference import codec

    b = batch // rows
    n = cfg["patch_size"][0] * cfg["patch_size"][1]
    chans = codec.channel_sizes(tuple(cfg["image_size"]), tuple(cfg["scale_factor"]))
    m = [(p[0] // cfg["patch_size"][0]) * (p[1] // cfg["patch_size"][1])
         for p in (codec.padded(c, tuple(cfg["patch_size"])) for c in chans)]
    r = codec.ranks(tuple(cfg["image_size"]), cfg["quality"], tuple(cfg["scale_factor"]), tuple(cfg["patch_size"]))
    return [(b, m[0], n, r[0]), (2 * b, m[1], n, r[1])] * rows


def _window(gen, feed_records, first: dict, kept: list, rng, sample: int, measure, t0: float, prof, trace_at,
            trace_s):
    """Drain `gen`, timing each answer; keep each pool batch's first answer,
    and of the later answers a uniform sample of `sample` drawn from `rng`
    (reservoir sampling), to be compared after the window: nothing but a
    draw stays on the pipeline's calling thread. Starts and stops the
    profiler at `trace_at` / `trace_at + trace_s` seconds into the window."""
    k = later = 0
    while True:
        with torch.profiler.record_function(NEXT_SPAN) if prof is not None and prof.active else nullcontext():
            try:
                out = next(gen)
            except StopIteration:
                break
        now = time.perf_counter()
        rec = feed_records[k]
        k += 1
        rec.t_out = now
        rec.pixels, rec.nbytes = measure(out)
        if rec.pool_index not in first:
            first[rec.pool_index] = out
        else:
            later += 1
            if len(kept) < sample:
                kept.append((rec.pool_index, out))
            else:
                j = int(rng.integers(later))
                if j < sample:
                    kept[j] = (rec.pool_index, out)
        if prof is not None:
            if prof.prof is None and now >= t0 + trace_at:
                prof.start()
            elif prof.active and now >= prof.t_start + trace_s:
                prof.stop()
    if prof is not None and prof.active:
        prof.stop()


def run(cell: Cell, seed: int, seconds: float, trace: bool, devices: list, t_process: float, log) -> dict:
    """One run of `cell` on `devices`; returns the result line's object."""
    from lrf_tpu_torch.ops.bcd_kernel import KERNEL
    from lrf_tpu_torch.parallel.decode import sharded_qmf_decode_batches
    from lrf_tpu_torch.parallel.encode import sharded_qmf_encode_batches
    from lrf_tpu_torch.parallel.mesh import make_mesh

    cfg, mix = cell.config, cell.mix
    kind = mix["kind"]
    rows = int(mix.get("rows", 1))
    devices = list(devices)[: max(rows, 1)]
    mesh = devices[0] if rows == 1 else make_mesh(data=rows, devices=devices)
    size = tuple(cfg["image_size"])
    batch = int(cfg["batch"]) * rows
    kw = _encoder_args(cfg)
    depth = int(mix.get("depth", 3))
    pool = images.make_pool(cfg["images"], size, batch, int(mix["pool"]), seed, devices[0])
    warm = int(mix["warmup_batches"])
    log(f"cell {cell.name}: {len(pool)} pool batches of {batch} x 3x{size[0]}x{size[1]}, {rows} data row(s) on "
        f"{devices}, depth {depth}, {warm} untimed batches")

    if kind == "encode":
        list(sharded_qmf_encode_batches([pool[j % len(pool)] for j in range(warm)], device=mesh, depth=depth, **kw))
        streams = None

        def start(feed):
            return sharded_qmf_encode_batches(feed, device=mesh, depth=depth, **kw)

        def measure(out):
            return batch * size[0] * size[1], sum(len(s) for s in out)

        same = list.__eq__
        items = pool
    elif kind == "decode":
        streams = list(sharded_qmf_encode_batches(pool, device=mesh, depth=depth, **kw))
        transport = mix.get("transport", "flat")
        list(sharded_qmf_decode_batches([streams[j % len(streams)] for j in range(warm)], device=mesh,
                                        transport=transport))

        def start(feed):
            return sharded_qmf_decode_batches(feed, device=mesh, out="host", transport=transport)

        def measure(out):
            return int(np.prod(out.shape[:1] + out.shape[2:])), 0

        same = np.array_equal
        items = streams
    else:
        raise ValueError(f"mix kind {kind!r}: 'encode' or 'decode'")
    cuda = [torch.device(d) for d in devices if torch.device(d).type == "cuda"]
    for d in cuda:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)

    prof = Profile(devices, lambda: KERNEL.launches) if trace else None
    trace_at = TRACE_FROM * seconds
    trace_s = min(TRACE_SECONDS, 0.5 * seconds)
    records: list = []
    first: dict = {}
    kept: list = []
    rng = np.random.default_rng([seed % 2**63, 1])
    t0 = time.perf_counter()
    t_end = t0 + seconds
    setup_s = t0 - t_process

    def feed():
        i = 0
        while time.perf_counter() < t_end:
            records.append(Batch(i % len(items), time.perf_counter()))
            yield items[i % len(items)]
            i += 1

    _window(start(feed()), records, first, kept, rng, int(mix["sample"]), measure, t0, prof, trace_at, trace_s)
    memory_peak = max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)
    ctx = Context(kind, setup_s, seconds, t0, t_end, records, devices, cfg, mix,
                  launch_shapes=_launch_shapes(cfg, batch, rows))
    done = ctx.done()
    log(f"window: {len(records)} batches handed, {len(done)} answered in {seconds} s; setup {setup_s:.3f} s")
    if done:
        lat = sorted((b.t_out - b.t_in) * 1e3 for b in done)
        log(f"batch ms: {len(lat)} batches, median {statistics.median(lat):.3f}, p95 "
            f"{float(np.percentile(lat, 95)):.3f}, max {lat[-1]:.3f}")
    if prof is not None and prof.t_stop is not None:
        ctx.trace = prof.summary()
        ctx.traced = (prof.t_begin, prof.t_done)
        ctx.bcd_launches = prof.counted
        log(f"traced {ctx.trace.window_s:.3f} s: busy s per card {ctx.trace.busy_s}; {ctx.bcd_launches} BCD launches")
        if rows == 1:
            if kind == "encode":
                ctx.stages = stages.encode_stages(pool[0], devices[0], kw, STAGE_REPS)
            else:
                ctx.stages = stages.decode_stages(streams[0], mesh, mix.get("transport", "flat"), STAGE_REPS)
            log(f"stages (median of {STAGE_REPS}): {ctx.stages}")

    unlike = sum(not same(out, first[j]) for j, out in kept)
    log(f"{unlike} of {len(kept)} later answers (a sample drawn from the seed) unlike their pool batch's first")
    kept.clear()
    # The program's state goes before the reference runs.
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if kind == "encode":
        numbers = compare.encode_numbers(first, pool, cfg, devices[0], chunk=CHECK_CHUNK)
    else:
        numbers = compare.decode_cell_numbers(first, streams, pool, cfg, devices[0], chunk=CHECK_CHUNK)
    numbers["unlike_first"] = unlike
    log(f"reference check: {time.perf_counter() - t_ref:.3f} s over {len(first)} pool batches")
    correct, checks = compare.judge(numbers, cell.limits)
    failed = 0 if correct else len(records)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {
        "platform": "gpu" if cuda else devices[0],
        "kind": torch.cuda.get_device_name(cuda[0]) if cuda else "cpu",
        "count": len(devices),
        "memory_peak_bytes": memory_peak,
        "power_limit_w": power_limit_w() if cuda else None,
    }
    result = {"correct": correct, "attempted": len(records), "failed": failed, "metrics": metrics, "device": device}
    if trace and ctx.trace is not None:
        t = ctx.trace
        device["busy_s"] = sum(t.busy_s.values()) / max(len(t.busy_s), 1)
        device["window_s"] = t.window_s
        top = sorted(t.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(t.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:200], s] for n, s in top], "idle_gaps": [[n[:200], s] for n, s in gaps]}
    result["checks"] = checks
    return result

