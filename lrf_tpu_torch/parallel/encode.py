"""Batched QMF encode of same-size images on one device or a device mesh.

Port of `lrf_tpu/parallel/encode.py`. Every entry point takes `device=`:
one device, or a `Mesh` (`parallel/mesh.py`) in place of the JAX mesh. A
`(B, 3, H, W)` batch runs as one batched pipeline: color transform, chroma
downsample, pad, patchify, then the factorization of each channel's
`(B, M, N)` patch stack:

- Cb and Cr share shape and rank at every canonical config, so they are
  merged into ONE `(2B, M, N)` BCD batch;
- `init="svd"` (default): one batched eigh over all channels' `(N, N)`
  Grams initializes every stack (`svd_init_shared`), when every stack is
  tall (M >= N); Grams in float64 rounded once, the eigh on the host's
  LAPACK on every device (`ops/svd.py`); `init="fast"`: the randomized range-finder
  (`ops/svd.py`), one per stack, three K x K eighs in place of the N x N
  one, at a small rate-distortion cost (the opt-in throughput init);
- the BCD loop goes through `lrf_tpu_torch.ops.bcd_kernel.bcd`: the CUDA
  kernel on a GPU, one launch for Y and one for the merged chroma.

On a mesh the batch is split contiguously over the data rows and each
row's images run the pipeline above on the row's device, from a host
thread of its own (`Mesh.map_rows`), the kernel once per stack and row.
With a patch axis > 1 each stack's M rows are split over the row's devices
and factorized by the plain sweeps with their sums over M taken across the
shards (`ops/bcd.py::sharded_bcd`); the fused kernel cannot reduce across
shards inside its loop.

The int8 factors, gathered on the mesh's first device, take one transport
to the host. On a card with int8 factors of a known batch and a coder that
gives zlib-9 bytes ("zlib" at level 9, or "best" in a native build without
libdeflate, as on a host without it), their fibers are DEFLATEd on the card
(`ops/deflate.py`): the fetch carries the streams and their lengths to
pinned host memory, and the host only frames them. Otherwise the raw
factors are fetched and the host tail (`_serialize_batch`) turns them into
finished streams in one native call (`native/fibercodec.cpp`: per-fiber
DEFLATE and framing). Both give the same bytes.
`sharded_qmf_encode_batches` pipelines many batches: device work and copies
stay on the calling thread while two workers serialize earlier batches. On
one device under the exact shared init the encoder splits at the host eigh
(its `start` and `finish`), and the pipeline starts batch i+1 (staged
upload, front end, Grams and their copy to the host) before it finishes
batch i, so the card has work queued while the host runs the eigh.
Under a profiler both entry points record the `lrf.encode.*` spans of
`utils/profiling.py`.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch

from lrf_tpu_torch.models.container import (
    combine_bytes,
    dict_to_bytes,
    encode_matrix_plain,
    encode_tensor_batch,
    get_fiber_coder,
)
from lrf_tpu_torch.models.qmf import _channel_ranks, _padded_size
from lrf_tpu_torch.native import fibercodec as _native
from lrf_tpu_torch.ops import deflate as _deflate
from lrf_tpu_torch.ops.bcd import sharded_bcd, sharded_svd_init, svd_init, svd_init_from_eigh, svd_init_shared
from lrf_tpu_torch.ops.bcd_kernel import bcd, bcd_reference
from lrf_tpu_torch.ops.color import rgb_to_ycbcr
from lrf_tpu_torch.ops.pad import pad_image
from lrf_tpu_torch.ops.patch import patchify
from lrf_tpu_torch.ops.quantize import torch_dtype
from lrf_tpu_torch.ops.resample import chroma_downsample, scaled_size
from lrf_tpu_torch.ops.svd import host_eigh, shared_gram
from lrf_tpu_torch.parallel.mesh import Mesh, as_mesh
from lrf_tpu_torch.utils import profiling
from lrf_tpu_torch.utils.transfer import HostCopy

__all__ = [
    "ENCODE_OVERLAP_COUNTS",
    "build_sharded_encoder",
    "sharded_qmf_encode_batch",
    "sharded_qmf_encode_batches",
]

# "auto": `bcd` (the CUDA kernel on a GPU, the plain sweeps on the CPU),
# except under patch sharding, where the plain sweeps run across shards;
# "kernel": `bcd` always (refused under patch sharding);
# "torch": the plain PyTorch sweeps on any device (`bcd_reference`).
_BACKENDS = ("auto", "kernel", "torch")
_INITS = ("svd", "fast")

# Batches of the one-device schedule: "staged" (host batches uploaded to a
# card through the page-locked staging blocks), "overlapped" (started while
# the previous batch still waited for its finish), and "ready" (finishes
# whose Grams had reached the host before the wait for them began).
ENCODE_OVERLAP_COUNTS = {"staged": 0, "overlapped": 0, "ready": 0}


class _Deflated(tuple):
    """`deflate_fibers`' `(slots, lens)`, made on the device's side stream
    (`ops/deflate.py::side_stream`), which `_start_fetch` copies them on;
    with the `lrf.encode.deflate` span of their launch (None while nothing
    records), whose `bytes_out` the fetch fills in once the lengths reach
    the host."""

    span = None
    stream = None


def _card_deflate(device: torch.device, dtype, batch, ms) -> bool:
    """Whether a batch's raw factors are DEFLATEd on the card: a CUDA device,
    int8 factors of a known batch, a coder that gives zlib-9 bytes ("zlib"
    at level 9, or "best" in a native build without libdeflate), and fibers
    within the kernel's bound. Read when the encoder is built."""
    if device.type != "cuda" or batch is None or np.dtype(dtype) != np.int8:
        return False
    backend, level = get_fiber_coder()
    if not ((backend == "zlib" and level == 9) or (backend == "best" and "deflate" not in _native.backends())):
        return False
    with torch.cuda.device(device):
        return max(ms) <= _deflate.KERNEL.max_fiber()


class _Started(NamedTuple):
    """A batch begun by the encoder's `start`: on one device under the exact
    shared init, its stacks and their Grams on their way to the host, which
    `finish` takes on from; elsewhere the batch's finished output."""

    out: object = None
    stacks: Optional[list] = None
    ranks: tuple = ()
    b: int = 0
    grams: Optional[HostCopy] = None


def _encoder(mesh, ranks, scale_factor, patch_size, bounds, num_iters, dtype, backend, on_card, init):
    """The batched encode function for one config: `(B, 3, H, W)` -> the 6
    factors on the mesh's first device, or (`on_card`) the card's DEFLATE
    output. Its `start` and `finish` split it at the host eigh, where a
    batch takes the exact shared init on one device: `start` enqueues the
    front end and the Grams and starts their copy to the host, and
    `finish` runs the eigh and enqueues the rest."""
    run_bcd = bcd_reference if backend == "torch" else bcd
    method = "randomized" if init == "fast" else "gram"

    def shared(stacks, merged) -> bool:
        """Whether the stacks take the exact shared init: one eigh over
        every stack's Grams, when they are merged and all tall."""
        return init == "svd" and merged and all(x.shape[-2] >= x.shape[-1] for x in stacks)

    def factorize(stacks, stack_ranks, merged):
        """One device: the init, then one BCD run per stack."""
        with profiling.span("lrf.encode.init"):
            if shared(stacks, merged):
                inits = svd_init_shared(stacks, stack_ranks, bounds=bounds)
            else:
                inits = [svd_init(x, r, method=method, bounds=bounds) for x, r in zip(stacks, stack_ranks)]
        return run_all(stacks, inits)

    def run_all(stacks, inits):
        with profiling.span("lrf.encode.bcd"):
            return [run_bcd(x, i[0], i[1], num_iters=num_iters, bounds=bounds) for x, i in zip(stacks, inits)]

    def factorize_sharded(stacks, stack_ranks, devices):
        """A data row's patch devices: each stack's M rows split over them,
        the init and the plain sweeps summed across the shards."""
        shards = [[p.to(d, non_blocking=True) for p, d in zip(torch.tensor_split(x, len(devices), dim=1), devices)]
                  for x in stacks]
        with profiling.span("lrf.encode.init"):
            inits = sharded_svd_init(shards, stack_ranks, bounds, method)
        out = []
        with profiling.span("lrf.encode.bcd"):
            for xs, (us, v) in zip(shards, inits):
                us, v = sharded_bcd(xs, us, v, num_iters=num_iters, bounds=bounds)
                out.append((torch.cat([u.to(devices[0], non_blocking=True) for u in us], dim=1), v))
        return out

    def front_end(images: torch.Tensor):
        """`(stacks, stack_ranks, merged)`: the patch stacks, Cb and Cr
        merged into one where they share shape and rank."""
        with profiling.span("lrf.encode.frontend"):
            channels = chroma_downsample(rgb_to_ycbcr(images), scale_factor)
            stacks = [patchify(pad_image(c, patch_size), patch_size) for c in channels]
        merged = stacks[1].shape == stacks[2].shape and ranks[1] == ranks[2]
        if merged:
            return [stacks[0], torch.cat(stacks[1:], dim=0)], ranks[:2], merged
        return stacks, ranks, merged

    def cast(per_stack, merged, b):
        if merged:
            (u_y, v_y), (u_c, v_c) = per_stack
            per_stack = [(u_y, v_y), (u_c[:b], v_c[:b]), (u_c[b:], v_c[b:])]
        return [f.to(dtype) for uv in per_stack for f in uv]

    def encode_row(images: torch.Tensor, devices):
        stacks, stack_ranks, merged = front_end(images)
        if len(devices) > 1:
            per_stack = factorize_sharded(stacks, stack_ranks, devices)
        else:
            per_stack = factorize(stacks, stack_ranks, merged)
        return cast(per_stack, merged, images.shape[0])

    def output(factors):
        if on_card:
            side = _deflate.side_stream(mesh.first)
            side.wait_stream(torch.cuda.current_stream(mesh.first))
            with torch.cuda.stream(side), profiling.span("lrf.encode.deflate",
                                                         bytes_in=sum(f.nbytes for f in factors)) as s:
                for f in factors:
                    f.record_stream(side)
                out = _Deflated(_deflate.deflate_fibers(factors))
            out.span, out.stream = s, side
            return out
        return tuple(factors)

    def start(images: torch.Tensor) -> _Started:
        if mesh.size == 1:
            images = mesh.split_batch(images)[0]
            stacks, stack_ranks, merged = front_end(images)
            if shared(stacks, merged):
                with profiling.span("lrf.encode.gram"):
                    grams = HostCopy([shared_gram(stacks)])
                return _Started(stacks=stacks, ranks=stack_ranks, b=images.shape[0], grams=grams)
            return _Started(output(cast(factorize(stacks, stack_ranks, merged), merged, images.shape[0])))
        if len(mesh.devices) == 1:
            parts = mesh.split_batch(images)
        else:  # each row's part to its row: the batch's upload (`_to_device` leaves it where it is)
            with profiling.span("lrf.encode.upload", bytes_in=images.nbytes) as s:
                if s is not None:
                    s.attrs = {"pinned": False}
                parts = mesh.split_batch(images)
        rows = mesh.map_rows(encode_row, parts)
        return _Started(output(rows[0] if len(rows) == 1 else
                               [torch.cat([r[k].to(mesh.first) for r in rows]) for k in range(6)]))

    def finish(started: _Started):
        if started.grams is None:
            return started.out
        with profiling.span("lrf.encode.init"):
            with profiling.span("lrf.encode.init.gram_fetch") as s:
                ready = started.grams.ready()
                (host,) = started.grams.wait()
                if s is not None:
                    s.bytes_in, s.attrs = host.nbytes, {"ready": ready}
            ENCODE_OVERLAP_COUNTS["ready"] += ready
            inits = svd_init_from_eigh(started.stacks, started.ranks, *host_eigh(host, mesh.first), bounds=bounds)
        return output(cast(run_all(started.stacks, inits), True, started.b))

    def encode(images: torch.Tensor):
        return finish(start(images))

    encode.start, encode.finish = start, finish
    return encode


def build_sharded_encoder(
    device,
    image_size: tuple[int, int],
    quality: Optional[float | tuple] = None,
    rank: Optional[int | tuple] = None,
    scale_factor: tuple[float, float] = (0.5, 0.5),
    patch_size: tuple[int, int] = (8, 8),
    bounds: tuple[float, float] = (-16, 15),
    num_iters: int = 10,
    dtype=np.int8,
    backend: str = "auto",
    pack=None,
    batch: Optional[int] = None,
    init: str = "svd",
):
    """A batched YCbCr-patch encoder for one config on `device` (one device
    or a `Mesh`).

    Returns `(encode_fn, metadata, pack_spec)`: `encode_fn(images)` maps a
    `(B, 3, H, W)` tensor (on the device; on a mesh with several data rows,
    anywhere) to the 6 per-channel factor tensors `(B, ., R)` on the mesh's
    first device, or, where the card DEFLATEs the fibers (int8 factors of a
    known `batch` on a card, under a coder that gives zlib-9 bytes:
    `_card_deflate`), to their zlib streams in fixed slots and their
    lengths, made on the device's side stream: fetch them with
    `_start_fetch`, which copies on that stream, or after synchronizing the
    device; `metadata` is the stream metadata every image shares;
    `pack_spec` is None for raw factors, or what the host needs to frame the
    card's streams (mode "zlib9"). On a mesh B must divide evenly over the
    data rows.

    `pack`: None, False or "" only; the benchmark harness
    (`portbench/harness.py`) passes it. `backend`: "auto" (the BCD kernel
    on a GPU; the plain sweeps across shards when the mesh's patch axis is
    > 1), "kernel" (the BCD kernel always; refused under patch sharding)
    or "torch" (plain sweeps).
    `init`: "svd" (default; the exact shared-eigh init) or "fast" (the
    randomized range-finder per stack; other, near-equal bytes).
    """
    if rank is None and quality is None:
        raise ValueError("Either 'rank' or 'quality' must be specified.")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {_BACKENDS}")
    if init not in _INITS:
        raise ValueError(f"unknown init {init!r}; one of {_INITS}")
    mesh = as_mesh(device)
    if backend == "kernel" and mesh.shape["patch"] > 1:
        raise NotImplementedError(
            "backend='kernel' runs on data-parallel meshes; the fused BCD loop cannot sum over M across patch "
            "shards, so patch-sharded factorization takes the plain sweeps (backend='auto' picks them)"
        )
    size = tuple(image_size)
    patch_size = tuple(patch_size)
    chroma_size = scaled_size(size, scale_factor)
    ch_sizes = (size, chroma_size, chroma_size)
    ranks = _channel_ranks(ch_sizes, rank, quality, True, patch_size)
    padded_sizes = [_padded_size(s, patch_size) for s in ch_sizes]
    metadata = {
        "dtype": "uint8",
        "color space": "YCbCr",
        "patch": True,
        "bounds": list(bounds),
        "patch size": list(patch_size),
        "original size": [list(s) for s in ch_sizes],
        "padded size": padded_sizes,
        "rank": list(ranks),
    }
    if pack not in (None, False, ""):
        raise ValueError(
            f"unknown pack {pack!r}: the encoder has one transport, raw factors DEFLATEd on the card where it can, "
            "whose streams the former 'flat' and 'entropy' packs only ever equalled; pass None"
        )
    pack_spec = None
    p, q = patch_size
    shapes = []
    for padded, r in zip(padded_sizes, ranks):
        shapes.append((batch, (padded[0] // p) * (padded[1] // q), r))  # u
        shapes.append((batch, p * q, r))  # v
    shapes = tuple(shapes)
    if _card_deflate(mesh.first, dtype, batch, [s[1] for s in shapes]):
        pack_spec = {"mode": "zlib9", "shapes": shapes, "caps": tuple(_deflate.slot_caps([s[1] for s in shapes]))}
    fn = _encoder(
        mesh, ranks, tuple(scale_factor), patch_size, tuple(bounds), num_iters, torch_dtype(dtype), backend,
        pack_spec is not None, init,
    )
    return fn, metadata, pack_spec


class _StagingRing:
    """Page-locked blocks that carry input batches from host memory to a
    card, used in turn. `upload` copies a batch into the next block
    (torch's CPU `copy_`, spread over its intra-op threads with the GIL
    released), enqueues the block's copy to the device with `non_blocking`
    and records an event behind it. A block is written again only after
    that event has passed, so a copy in flight never sees its source
    change. A block is made at its first use, and again where the batch's
    shape or dtype changes; torch's caching host allocator keeps the one it
    replaces until its copy has ended."""

    def __init__(self, blocks: int):
        self._slots: list = [None] * blocks  # (block, event of its last copy)
        self._turn = 0

    def upload(self, x: torch.Tensor, device: torch.device) -> torch.Tensor:
        k = self._turn
        self._turn = (k + 1) % len(self._slots)
        block, event = self._slots[k] or (None, None)
        if block is not None and block.shape == x.shape and block.dtype == x.dtype:
            event.synchronize()
        else:
            block = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        block.copy_(x)
        out = block.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        self._slots[k] = (block, event)
        return out


def _to_device(images, mesh: Mesh, ring: _StagingRing) -> torch.Tensor:
    """The batch as a tensor: on the device of a one-row mesh, else where it
    is (`Mesh.split_batch` moves each row's part to its row). A host batch
    bound for a one-device mesh on a card goes through `ring`."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images))
    if len(mesh.devices) > 1:
        return images
    pinned = mesh.size == 1 and mesh.first.type == "cuda" and images.device.type == "cpu"
    with profiling.span("lrf.encode.upload", bytes_in=images.nbytes) as s:
        if s is not None:
            s.attrs = {"pinned": pinned}
        if not pinned:
            return images.to(mesh.first)
        ENCODE_OVERLAP_COUNTS["staged"] += 1
        return ring.upload(images, mesh.first)


def _start_fetch(out) -> HostCopy:
    """The encoder's output on its way to pinned host memory, on the stream
    that made it."""
    stream = getattr(out, "stream", None)
    with profiling.span("lrf.encode.fetch_start", bytes_in=sum(t.nbytes for t in out)), (
        torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
    ):
        copy = HostCopy(out)
    copy.deflate_span = getattr(out, "span", None)
    return copy


def _fetch_encoded(copy: HostCopy, pack_spec):
    """Wait for a fetch and return what `_serialize_batch` takes: the 6
    factor arrays, or the card's `(slots, lens)`. `pack_spec` chooses
    nothing; the benchmark's stage timer (`portbench/stages.py`) passes it."""
    with profiling.span("lrf.encode.fetch_wait", mirror=True):
        host = copy.wait()
    span = getattr(copy, "deflate_span", None)  # the card's DEFLATE, when it ran
    if span is not None:
        span.bytes_out = int(host[1].sum(dtype=np.int64))
    return host


def _inner_metadata(rs) -> list[bytes]:
    return [dict_to_bytes({"num_fibers": int(r), "mode": "col", "dtype": "int8"}) for r in rs]


def _serialize_batch(host_out, pack_spec, metadata, b: int) -> list[bytes]:
    """Host tail of batch encoding: fetched buffers -> per-image streams.

    Takes numpy buffers only, never tensors, so it runs on a worker thread
    beside device work on the calling thread. The card's zlib streams take
    one native call that frames them; raw int8 factors one that does the
    whole stream assembly (per-fiber DEFLATE with the process-wide coder,
    inner metadata, framing); other dtypes go through the container per
    factor.
    """
    backend, level = get_fiber_coder()
    encoded_metadata = dict_to_bytes(metadata)
    if pack_spec is not None:
        slots, lens = host_out
        rs = [s[2] for s in pack_spec["shapes"]]
        return _native.frame_streams(slots, lens, b, rs, pack_spec["caps"], encoded_metadata, _inner_metadata(rs))
    if all(f.dtype == np.int8 and f.ndim == 3 for f in host_out):
        rs = [f.shape[2] for f in host_out]
        return _native.assemble_streams(
            host_out, b, [f.shape[1] for f in host_out], rs, encoded_metadata, _inner_metadata(rs), level, backend
        )
    per_factor_blobs = [encode_tensor_batch(f) for f in host_out]
    return [
        combine_bytes([encoded_metadata, combine_bytes([blobs[i] for blobs in per_factor_blobs])]) for i in range(b)
    ]


def _serialize_spanned(host_out, pack_spec, metadata, b: int, parent=None, submitted_ns=None) -> list[bytes]:
    """`_serialize_batch` under the `lrf.encode.serialize` span, after the
    `lrf.encode.serializer_queue` span from `submitted_ns` when it waited
    in a worker pool's queue; `parent` is the submitting batch's span."""
    if submitted_ns is not None:
        profiling.record("lrf.encode.serializer_queue", submitted_ns, parent=parent)
    with profiling.span("lrf.encode.serialize", parent=parent, bytes_in=sum(a.nbytes for a in host_out)) as s:
        streams = _serialize_batch(host_out, pack_spec, metadata, b)
        if s is not None:
            s.bytes_out = sum(len(x) for x in streams)
    return streams


def _serialize_plain(host_factors, metadata, b: int, level: int = 9) -> list[bytes]:
    """Plain version of `_serialize_batch` on raw `(B, M, R)` factors: one
    CPython `zlib.compress` per fiber and Python framing. Its bytes equal
    `_serialize_batch`'s under the "zlib" coder at the same level."""
    encoded_metadata = dict_to_bytes(metadata)
    per_factor = [[encode_matrix_plain(f[i], "col", level) for i in range(b)] for f in host_factors]
    return [combine_bytes([encoded_metadata, combine_bytes([blobs[i] for blobs in per_factor])]) for i in range(b)]


def sharded_qmf_encode_batch(
    images,
    device="cuda",
    quality: Optional[float | tuple] = None,
    rank: Optional[int | tuple] = None,
    **config,
) -> list[bytes]:
    """Encode a `(B, 3, H, W)` uint8 batch into per-image QMF byte streams.

    On the CPU the streams are byte-identical to per-image
    `lrf_tpu_torch.qmf_encode`. On a GPU the BCD kernel sums in another
    order than the plain sweeps, so a small share of factor entries can
    differ at round() ties; every stream decodes with either package.
    `device` may be a `Mesh`: on the CPU a data mesh gives the one
    device's bytes, and a patch-sharded one near-equal streams (the sums
    over M are split). The arguments are in the JAX package's order,
    `(images, mesh, quality, rank, **config)`.
    """
    mesh = as_mesh(device)
    profiling.follow_profiler()
    root = profiling.begin("lrf.encode.batch", batch=0)
    try:
        with profiling.within(root):
            b, size = int(images.shape[0]), (int(images.shape[-2]), int(images.shape[-1]))
            fn, metadata, pack_spec = build_sharded_encoder(mesh, size, quality=quality, rank=rank, batch=b, **config)
            host_out = _fetch_encoded(_start_fetch(fn(_to_device(images, mesh, _StagingRing(1)))), pack_spec)
            return _serialize_spanned(host_out, pack_spec, metadata, b)
    finally:
        profiling.end(root)


def sharded_qmf_encode_batches(
    batches,
    device="cuda",
    quality: Optional[float | tuple] = None,
    rank: Optional[int | tuple] = None,
    depth: int = 3,
    **config,
):
    """Pipelined encode of a sequence of `(B, 3, H, W)` batches.

    Generator yielding `list[bytes]` per input batch, in order. Each batch's
    encode is dispatched and its device -> pinned-host copy started on the
    calling thread, up to `depth` batches ahead of the fetch; fetched
    buffers go to two serializer workers (native, GIL-released C++), so
    device work, copies and host DEFLATE overlap. On one device under the
    exact shared init the calling thread runs one batch ahead: it stages
    batch i+1's upload and enqueues its front end and Grams (the encoder's
    `start`) before it runs batch i's host eigh and enqueues the rest
    (`finish`), so the card works on batch i+1 during that eigh. Host
    batches bound for a card go through two page-locked staging blocks:
    batch i's finish waits for its Grams, which the stream computes after
    batch i's upload, so batch i+2 finds batch i's block free. The
    serializer workers touch only numpy and the native library, never
    torch. The one exception to keeping torch calls on the calling thread
    is a mesh with several data rows: the encoder dispatches each row from
    a thread of its own (`Mesh.map_rows`) and joins them before it returns.
    Streams equal `sharded_qmf_encode_batch`'s. The arguments are in the
    JAX package's order: `(batches, mesh, quality, rank, depth)`.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    mesh = as_mesh(device)
    profiling.follow_profiler()
    ring = _StagingRing(2)
    with ThreadPoolExecutor(max_workers=2) as pool:
        started = None  # (fn, _Started, pack_spec, metadata, b, root span): begun, not finished
        in_flight = deque()  # (copy, pack_spec, metadata, b, root span)
        pending = deque()  # (future of list[bytes], root span), in batch order

        def finish(fn, begun, pack_spec, metadata, b, root):
            with profiling.within(root):
                in_flight.append((_start_fetch(fn.finish(begun)), pack_spec, metadata, b, root))
            if len(in_flight) > depth:
                drain_one()

        def drain_one():
            copy, pack_spec, metadata, b, root = in_flight.popleft()
            with profiling.within(root):
                host_out = _fetch_encoded(copy, pack_spec)
            fut = pool.submit(_serialize_spanned, host_out, pack_spec, metadata, b, root, time.perf_counter_ns())
            profiling.end(root)
            pending.append((fut, root))

        def result():
            profiling.follow_profiler()
            fut, root = pending.popleft()
            with profiling.span("lrf.encode.result_wait", parent=root, mirror=True):
                return fut.result()

        for seq, images in enumerate(batches):
            profiling.follow_profiler()
            root = profiling.begin("lrf.encode.batch", batch=seq)
            with profiling.within(root):
                b, size = int(images.shape[0]), (int(images.shape[-2]), int(images.shape[-1]))
                fn, metadata, pack_spec = build_sharded_encoder(
                    mesh, size, quality=quality, rank=rank, batch=b, **config
                )
                begun = fn.start(_to_device(images, mesh, ring))
            if started is not None:
                ENCODE_OVERLAP_COUNTS["overlapped"] += 1
                finish(*started)
            started = (fn, begun, pack_spec, metadata, b, root)
            if begun.grams is None:  # nothing left to overlap
                finish(*started)
                started = None
            while len(pending) > 2:
                yield result()
        if started is not None:
            finish(*started)
        while in_flight:
            drain_one()
        while pending:
            yield result()
