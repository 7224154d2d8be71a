"""One batch through each layer of the pipelines alone, timed from the
benchmark around its calls into the program: the per-layer metrics'
stage times, taken after the traced window, median of `reps` runs."""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch


def _median_ms(fn, reps: int, sync) -> float:
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _event_ms(fn, reps: int, device) -> float:
    """Median device ms of `fn` between two CUDA events; host clock on the CPU."""
    if device.type != "cuda":
        return _median_ms(fn, reps, lambda: None)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def encode_stages(batch: np.ndarray, device, kw: dict, reps: int) -> dict:
    """`frontend_ms`, `init_ms`, `fetch_ms` and `serialize_ms` of one batch
    encoded on one device with the encoder's arguments `kw`."""
    from lrf_tpu_torch.ops import color, pad, patch, resample
    from lrf_tpu_torch.ops.bcd import svd_init_shared
    from lrf_tpu_torch.parallel import encode as penc
    from lrf_tpu_torch.utils.transfer import HostCopy

    device = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    x = torch.from_numpy(batch).to(device)
    b, size = batch.shape[0], batch.shape[-2:]
    patch_size = tuple(kw["patch_size"])

    def front_end():
        chans = resample.chroma_downsample(color.rgb_to_ycbcr(x), tuple(kw["scale_factor"]))
        return [patch.patchify(pad.pad_image(c, patch_size), patch_size) for c in chans]

    out = {"frontend_ms": _event_ms(front_end, reps, device)}
    stacks = front_end()
    rank = penc.build_sharded_encoder(device, size, batch=b, **kw)[1]["rank"]
    merged = [stacks[0], torch.cat(stacks[1:], dim=0)]
    out["init_ms"] = _median_ms(lambda: svd_init_shared(merged, rank[:2], bounds=tuple(kw["bounds"])), reps, sync)

    fn, metadata, spec = penc.build_sharded_encoder(device, size, batch=b, **kw)
    sent = fn(x)
    sync()
    out["fetch_ms"] = _median_ms(lambda: penc._fetch_encoded(HostCopy(sent), spec), reps, sync)
    host_out = penc._fetch_encoded(HostCopy(sent), spec)
    out["serialize_ms"] = _median_ms(lambda: penc._serialize_batch(host_out, spec, metadata, b), reps, sync)
    return out


def decode_stages(streams: list, mesh, transport: str, reps: int) -> dict:
    """`decode_host_ms` (parse, inflate, pack) and `decode_device_ms`
    (upload, reconstruction, pixels to the host) of one batch."""
    from lrf_tpu_torch.parallel import decode as pdec
    from lrf_tpu_torch.parallel.mesh import as_mesh

    mesh = as_mesh(mesh)
    cuda = [d for row in mesh.devices for d in row if d.type == "cuda"]

    def sync():
        for d in cuda:
            torch.cuda.synchronize(d)

    single = mesh.size == 1
    out = {"decode_host_ms": _median_ms(lambda: pdec._inflate_streams(streams, single, transport), reps, sync)}
    staged = pdec._inflate_streams(streams, single, transport)
    out["decode_device_ms"] = _median_ms(lambda: pdec._device_decode(*staged, mesh, "host"), reps, sync)
    return out
