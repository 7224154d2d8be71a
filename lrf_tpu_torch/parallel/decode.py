"""Batched QMF decode of homogeneous streams on one device or a device mesh.

Port of `lrf_tpu/parallel/decode.py`. The host parses every stream and
inflates all fibers natively (`lrf_decompress_fibers`), then packs the
factor values for the upload in one of two transports:

- `"flat"` (default): `lrf_pack_values`, `30 // bits` values per word,
  one `(B, words)` buffer, unpacked with shifts and masks on the device;
- `"dpack"`: delta + static Huffman (`lrf_dpack_encode`, the host mirror of
  the encoder's entropy pack), one flat buffer `[per-chunk row counts as
  bytes | main | used continuation rows]`, decoded on the device by
  `ops/entropy.py::unpack_chunks_device`. Only when one device decodes (its
  chunk stream interleaves the images, so it has no batch axis to split),
  and never for a batch whose rows overflow the budget or whose deltas
  leave the code's alphabet (`num_iters=0` streams): those take the flat
  pack, or the unpacked upload when a value is outside the bounds. Pixels
  are the same whatever the transport; `TRANSPORT_COUNTS` counts which one
  each batch took.

The JAX package picks the transport with `LRF_TPU_DECODE_TRANSPORT`; here
it is the `transport=` keyword. The reconstruction (U V^T per channel,
depatchify, unpad, nearest chroma upsample, YCbCr -> RGB, clamp-cast) runs
batched; on a mesh the batch is split over the data rows, each row
dispatched from a host thread of its own (`Mesh.map_rows`: the YCbCr
offset and the nearest upsample's indices are pageable uploads, which wait
on the row's device), and every device of a row
does the row's work (JAX's `P("data")` replicates it over the patch axis).
Per-image results equal `lrf_tpu_torch.qmf_decode`'s.

Pixels to the host: on a card each data row's pixels go, on the stream
that made them, by an asynchronous copy into the row's slice of one
page-locked `(B, 3, H, W)` block from torch's caching host allocator, with
an event per row (`_PixelCopy`); the answer is a numpy view of that block,
which returns to torch's cache when the caller drops the array, and is
never copied into again while the caller holds it. CPU pixels are taken as
they are. `PIXEL_COPY_COUNTS` counts the batches of each kind, and the
pinned ones whose copy had ended before the calling thread waited.

`sharded_qmf_decode_batches` overlaps three batches: the host stage of
batch i+1 on a worker, the device work of batch i, and the copy of batch
i-1's pixels, which the calling thread waits for only after it has
enqueued batch i. Under a profiler both entry points record the
`lrf.decode.*` spans of `utils/profiling.py`.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch

from lrf_tpu_torch.models.container import bytes_to_dict, decode_matrix_batch, separate_bytes
from lrf_tpu_torch.native import fibercodec as _native
from lrf_tpu_torch.ops import entropy as _entropy
from lrf_tpu_torch.ops.color import ycbcr_to_rgb
from lrf_tpu_torch.ops.pad import unpad_image
from lrf_tpu_torch.ops.patch import depatchify
from lrf_tpu_torch.ops.quantize import torch_dtype, to_dtype
from lrf_tpu_torch.ops.resample import chroma_upsample
from lrf_tpu_torch.parallel.encode import _pack_params
from lrf_tpu_torch.parallel.mesh import Mesh, as_mesh
from lrf_tpu_torch.utils import profiling

__all__ = ["PIXEL_COPY_COUNTS", "TRANSPORT_COUNTS", "sharded_qmf_decode_batch", "sharded_qmf_decode_batches"]

_TRANSPORTS = ("flat", "dpack")

# Per-config (metadata signature) bit-pack decisions: the first batch of a
# config decides whether its uploads are packed; see _inflate_streams.
_PACK_DECISIONS: dict = {}
# Per-config sticky dpack upload bucket: the most rows (in whole buckets) a
# batch of this config has needed, so the upload's size stays put across
# batches; rows past a batch's own are never read.
_DPACK_BUCKETS: dict = {}
_DPACK_BUCKET_ROWS = 4096

# Batches decoded per upload transport: "dpack", "flat" (bit-packed) or
# "unpacked" (a value outside the bounds, or a non-int8 factor).
TRANSPORT_COUNTS = {"dpack": 0, "flat": 0, "unpacked": 0}
# Batches' pixels to the host: "pinned" (an asynchronous copy into a
# page-locked block), "host" (CPU pixels taken as they are), and "ready":
# pinned batches whose copy had ended when the calling thread came to wait
# (the pipeline's overlap hit rate is ready / pinned).
PIXEL_COPY_COUNTS = {"pinned": 0, "host": 0, "ready": 0}


def _check_args(out: str, transport: str) -> None:
    if out not in ("host", "device"):
        raise ValueError("out must be 'host' or 'device'")
    if transport not in _TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; one of {_TRANSPORTS}")


def _inflate_streams(streams, single_device: bool = False, transport: str = "flat"):
    """Host stage: parse containers, inflate all fibers, pack the upload.

    Touches no torch state, so it runs on a worker thread beside device
    work. Returns `(flat, metadata, shapes, in_dtype, pack)`: the upload
    buffer, the shared metadata, the per-factor `(M, R)` shapes and the
    factors' dtype name. `pack` says what the buffer is: `("dpack", B,
    rows)` for the 1-D dpack upload, `(lo, bits, total)` for the `(B,
    words)` bit-packed one, None for the `(B, total)` factor values.
    `single_device` gates the dpack upload; it defaults to False, so a
    caller that does not derive it from its mesh never gets dpack there.
    """
    if len(streams) == 0:
        raise ValueError("no streams to decode")
    metadata = None
    per_factor: list[list[bytes]] = [[] for _ in range(6)]
    with profiling.span("lrf.decode.parse"):
        for stream in streams:
            encoded_metadata, encoded_factors = separate_bytes(stream, 2)
            md = bytes_to_dict(encoded_metadata)
            if metadata is None:
                metadata = md
                if md["color space"] != "YCbCr" or not md["patch"]:
                    raise ValueError(
                        "batched decode covers the YCbCr+patch format; use qmf_decode for RGB/no-patch streams"
                    )
            elif md != metadata:
                raise ValueError("streams must share one codec config")
            for k, blob in enumerate(separate_bytes(encoded_factors, 6)):
                per_factor[k].append(blob)
    b = len(streams)
    fast = _inflate_pack_native(per_factor, metadata, b, single_device and transport == "dpack")
    if fast is not None:
        return fast

    factors = [decode_matrix_batch(blobs) for blobs in per_factor]
    flat = np.concatenate([f.reshape(b, -1) for f in factors], axis=1)
    shapes = tuple(f.shape[1:] for f in factors)
    # Pack the upload when the factors fit their advertised bounds (always
    # for >= 1 BCD sweep; num_iters=0 streams hold unprojected SVD factors).
    # The first batch of a config decides, so a config keeps one upload
    # layout; every batch is still scanned, and one that breaks a cached
    # pack decision uploads unpacked.
    bounds = metadata.get("bounds")
    if bounds is not None and flat.dtype.kind == "i":
        lo, bits = _pack_params(bounds)
        hi = lo + (1 << bits) - 1
        in_bounds = bool(flat.min() >= lo and flat.max() <= hi)
        decision = _PACK_DECISIONS.setdefault(json.dumps(metadata, sort_keys=True), bits < 8 and in_bounds)
        if decision and in_bounds:
            total = flat.shape[1]
            vals_per_word = 30 // bits
            padded = -(-total // vals_per_word) * vals_per_word
            vals = (flat.astype(np.int64) - lo).astype(np.uint32)
            if padded != total:
                vals = np.concatenate([vals, np.zeros((b, padded - total), np.uint32)], axis=1)
            shifts = (np.arange(vals_per_word, dtype=np.uint32) * bits)[None, None, :]
            packed = np.bitwise_or.reduce(vals.reshape(b, -1, vals_per_word) << shifts, axis=2)
            return packed, metadata, shapes, flat.dtype.name, (lo, bits, total)
    return flat, metadata, shapes, flat.dtype.name, None


def _dpack_upload(raws, b: int, ms, rs, config_key: str):
    """The dpack upload of fiber-major int8 factors, or None when the rows
    overflow the budget or a delta leaves the alphabet. Only the used rows
    travel, rounded up to the config's sticky bucket."""
    c_total = sum(b * (-(-m * r // _entropy.CHUNK)) for m, r in zip(ms, rs))
    budget = _entropy.default_exc_rows(c_total)
    out = _native.dpack_encode(
        raws, b, ms, rs, _entropy.LENS, _entropy.CODES, _entropy.CHUNK, _entropy.MAIN_WORDS, _entropy.ROW_WORDS,
        budget,
    )
    if out is None:
        return None
    main, exc, chunk_rows, n_rows = out
    rows_u8 = np.zeros(-(-c_total // 4) * 4, np.uint8)
    rows_u8[:c_total] = chunk_rows
    needed = -(-max(n_rows, 1) // _DPACK_BUCKET_ROWS) * _DPACK_BUCKET_ROWS
    sticky = max(needed, _DPACK_BUCKETS.get(config_key, 0))
    _DPACK_BUCKETS[config_key] = sticky
    upload_rows = min(budget, sticky)
    upload = np.concatenate([rows_u8.view(np.uint32), main, exc[: upload_rows * _entropy.ROW_WORDS]])
    return upload, ("dpack", b, upload_rows)


def _inflate_pack_native(per_factor, metadata, b: int, dpack: bool):
    """Fused native inflate + pack of int8 column-fiber factors.

    Inflates each factor's fibers to its raw fiber-major buffer, then packs
    them straight into the upload: dpack when asked and it fits, else
    `lrf_pack_values`' `(B, words)`. Returns `_inflate_streams`' tuple, or
    None for the numpy route: no bounds, 8 or more bits, a non-int8 or
    row-fiber factor, a cached unpacked decision, or a value outside the
    bounds (the native pass doubles as that check).
    """
    bounds = metadata.get("bounds")
    if bounds is None:
        return None
    lo, bits = _pack_params(bounds)
    if bits >= 8:
        return None
    config_key = json.dumps(metadata, sort_keys=True)
    if _PACK_DECISIONS.get(config_key) is False:
        return None
    raws = []
    shapes = []
    for blobs_per_stream in per_factor:
        md = bytes_to_dict(separate_bytes(blobs_per_stream[0], 2)[0])
        if md.get("mode") != "col" or np.dtype(md["dtype"]) != np.int8:
            return None
        r = md["num_fibers"]
        fibers = []
        for blob in blobs_per_stream:
            fibers.extend(separate_bytes(separate_bytes(blob, 2)[1], r))
        raw = _native.decompress_fibers_raw(fibers, np.int8)  # (B * R, M) fiber-major
        raws.append(raw)
        shapes.append((raw.shape[1], r))
    ms, rs = [m for m, _ in shapes], [r for _, r in shapes]
    if dpack:
        up = _dpack_upload(raws, b, ms, rs, config_key)
        if up is not None:
            _PACK_DECISIONS.setdefault(config_key, True)
            return up[0], metadata, tuple(shapes), "int8", up[1]
    packed = _native.pack_values(raws, b, ms, rs, lo, bits)
    if packed is None:  # a value outside the bounds: unpacked upload
        _PACK_DECISIONS.setdefault(config_key, False)
        return None
    _PACK_DECISIONS.setdefault(config_key, True)
    return packed, metadata, tuple(shapes), "int8", (lo, bits, sum(m * r for m, r in shapes))


def _unpack(flat: torch.Tensor, shapes, in_dtype: str, pack) -> list[torch.Tensor]:
    """The upload buffer on the device -> the six float32 factors."""
    if pack is not None and pack[0] == "dpack":
        b = pack[1]
        shapes3 = [(b, m, r) for m, r in shapes]
        c_total = _entropy.segment_layout(shapes3)[2][-1]
        rows_words = -(-c_total // 4)
        rows_u8 = ((flat[:rows_words, None] >> torch.arange(0, 32, 8, device=flat.device)) & 0xFF).reshape(-1)
        main_end = rows_words + c_total * _entropy.MAIN_WORDS
        values = _entropy.unpack_chunks_device(rows_u8[:c_total], flat[rows_words:main_end], flat[main_end:], shapes3)
        return [v.to(torch.float32) for v in values]
    if pack is not None:
        lo, bits, total = pack
        vals_per_word = 30 // bits
        shifts = torch.arange(vals_per_word, dtype=torch.int32, device=flat.device) * bits
        vals = (flat[:, :, None] >> shifts) & ((1 << bits) - 1)
        flat = (vals.reshape(flat.shape[0], -1)[:, :total] + lo).to(torch_dtype(in_dtype))
    factors = []
    offset = 0
    for m, r in shapes:
        factors.append(flat[:, offset : offset + m * r].reshape(-1, m, r).to(torch.float32))
        offset += m * r
    return factors


def _reconstruct(flat: torch.Tensor, metadata, shapes, in_dtype: str = "int8", pack=None) -> torch.Tensor:
    """Upload buffer on the device -> `(B, 3, H, W)` images.

    `flat` is what `_inflate_streams` returned, on the device: the dpack or
    `(B, words)` bit-packed words as int32 (dpack words hold uint32 bit
    patterns; flat ones stay below 2^30), or the `(B, total)` values.
    """
    factors = _unpack(flat, shapes, in_dtype, pack)
    orig_sizes = [tuple(s) for s in metadata["original size"]]
    padded_sizes = [tuple(s) for s in metadata["padded size"]]
    patch_size = tuple(metadata["patch size"])
    ycbcr = []
    for i in range(3):
        x = torch.matmul(factors[2 * i], factors[2 * i + 1].transpose(-1, -2))
        channel = depatchify(x, padded_sizes[i], patch_size)
        ycbcr.append(unpad_image(channel, orig_sizes[i]))
    image = chroma_upsample(tuple(ycbcr), size=orig_sizes[0], mode="nearest")
    return to_dtype(ycbcr_to_rgb(image), metadata["dtype"])


class _PixelCopy:
    """One batch's pixels on their way to host memory.

    On a card, each data row copies its pixels, on the stream that made
    them, into its batch slice of one page-locked `(B, 3, H, W)` block from
    torch's caching host allocator (`copy_(non_blocking=True)`), and records
    an event; `wait()` returns a numpy view of the block, which goes back to
    the cache when the caller drops the array. A block is never handed out
    twice, so an array the caller holds never changes. CPU pixels are taken
    as they are.
    """

    def __init__(self, shape, dtype, devices):
        rows = len(devices)
        self._rows = shape[0] // rows
        self._parts: list = [None] * rows
        self._events: list = []
        self.pinned = any(d.type == "cuda" for d in devices)
        self._block = torch.empty(shape, dtype=dtype, pin_memory=True) if self.pinned else None

    def start(self, row: int, pixels: torch.Tensor) -> None:
        """Start row `row`'s copy; call it on the thread that made `pixels`."""
        if self._block is None:
            self._parts[row] = pixels
            return
        self._block[row * self._rows : (row + 1) * self._rows].copy_(pixels, non_blocking=True)
        if pixels.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(pixels.device))
            self._events.append(event)

    def ready(self) -> bool:
        """Whether every row's copy has ended."""
        return all(e.query() for e in self._events)

    def wait(self) -> np.ndarray:
        for e in self._events:
            e.synchronize()  # releases the GIL while it waits
        if self._block is not None:
            return self._block.numpy()
        parts = [p.numpy() for p in self._parts]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


class _Started(NamedTuple):
    """A batch whose device stage `_device_start` began."""

    span: Optional[profiling.Span]  # its open `lrf.decode.device`
    result: object  # a `_PixelCopy`, or the pixels on the device (``out="device"``)


def _device_start(flat: np.ndarray, metadata, shapes, in_dtype, pack, mesh: Mesh, out: str) -> _Started:
    """Enqueue a batch's upload and reconstruction and, for ``out="host"``,
    start its pixels' copy to the host."""
    if pack is None:
        kind = "unpacked"
    else:
        kind = "dpack" if pack[0] == "dpack" else "flat"
        flat = flat.view(np.int32)
    TRANSPORT_COUNTS[kind] += 1
    device_span = profiling.begin("lrf.decode.device")
    with profiling.within(device_span):
        with profiling.span("lrf.decode.upload", bytes_in=flat.nbytes):
            host = torch.from_numpy(flat)
            # dpack: one device by construction (_inflate_streams' gate)
            parts = [host.to(mesh.first)] if kind == "dpack" else mesh.split_batch(host)
        rows = [(mesh.first,)] if kind == "dpack" else mesh.devices
        copy = None
        if out == "host":
            b = pack[1] if kind == "dpack" else flat.shape[0]
            shape = (b, 3, *metadata["original size"][0])
            copy = _PixelCopy(shape, torch_dtype(metadata["dtype"]), [row[0] for row in rows])
        with profiling.span("lrf.decode.reconstruct"):

            def decode_row(indexed, devices):
                i, part = indexed
                pixels = [_reconstruct(part.to(d), metadata, shapes, in_dtype, pack) for d in devices][0]
                if copy is not None:
                    copy.start(i, pixels)
                return pixels

            if kind == "dpack":
                parts = [decode_row((0, parts[0]), rows[0])]
            else:
                parts = mesh.map_rows(decode_row, list(enumerate(parts)))
    if copy is not None:
        return _Started(device_span, copy)
    return _Started(device_span, parts[0] if len(parts) == 1 else torch.cat([p.to(mesh.first) for p in parts]))


def _device_finish(started: _Started):
    """Wait for what `_device_start` began: the pixels as a numpy array (a
    view of a page-locked block on a card), or the device tensor."""
    device_span, result = started
    if isinstance(result, _PixelCopy):
        with profiling.within(device_span), profiling.span("lrf.decode.to_host") as s:
            ready = result.ready()
            pixels = result.wait()
            PIXEL_COPY_COUNTS["pinned" if result.pinned else "host"] += 1
            if result.pinned and ready:
                PIXEL_COPY_COUNTS["ready"] += 1
            if s is not None:
                s.bytes_in = pixels.nbytes
                s.attrs = {"pinned": result.pinned, "ready": ready}
        result = pixels
    profiling.end(device_span)
    return result


def _device_decode(flat, metadata, shapes, in_dtype, pack, mesh: Mesh, out: str):
    """One batch's device stage, to its finished pixels. `flat` is the
    upload buffer of `_inflate_streams`, started here, or a `_Started`
    batch (the pipeline's, begun before the next batch was enqueued), only
    finished here: every answer of both entry points leaves through this."""
    if not isinstance(flat, _Started):
        flat = _device_start(flat, metadata, shapes, in_dtype, pack, mesh, out)
    return _device_finish(flat)


def sharded_qmf_decode_batch(streams, device="cuda", out: str = "host", transport: str = "flat"):
    """Decode homogeneous YCbCr-patch QMF streams as one batch on `device`
    (one device or a `Mesh`).

    Returns a `(B, 3, H, W)` array of the original dtype: numpy when
    ``out="host"`` (on a card, a view of a page-locked host block, copied
    into and waited for at once), the tensor on the mesh's first device
    when ``out="device"``. `transport`: the upload, `"flat"` (default) or
    `"dpack"` (one device only; see the module docstring).
    """
    _check_args(out, transport)
    mesh = as_mesh(device)
    profiling.follow_profiler()
    root = profiling.begin("lrf.decode.batch", batch=0)
    try:
        with profiling.within(root):
            return _device_decode(*_inflate_spanned(streams, mesh.size == 1, transport, root), mesh, out)
    finally:
        profiling.end(root)


def _inflate_spanned(streams, single_device: bool, transport: str, parent=None):
    """`_inflate_streams` under the `lrf.decode.inflate` span; `parent` is
    the batch's span (of the thread that submitted it)."""
    with profiling.span("lrf.decode.inflate", parent=parent, bytes_in=sum(len(x) for x in streams)) as s:
        staged = _inflate_streams(streams, single_device, transport)
        if s is not None:
            s.bytes_out = staged[0].nbytes
    return staged


def sharded_qmf_decode_batches(stream_batches, device="cuda", out: str = "host", transport: str = "flat"):
    """Pipelined decode of a sequence of homogeneous stream batches.

    Generator yielding one decoded `(B, 3, H, W)` array per input batch, in
    order. The host stage of batch i+1 (parse, native inflate and pack, on
    a worker thread, no torch state) overlaps the upload and reconstruction
    of batch i on the calling thread, where all torch work stays, except
    that a mesh with several data rows reconstructs each row on a thread of
    its own (`Mesh.map_rows`). Batch i-1's pixels travel to the host
    meanwhile: the calling thread waits for them (the wait releases the
    GIL) only once batch i is enqueued, then yields them. With
    ``out="host"`` on a card each answer is a view of its own page-locked
    host block; at most two batches' pixels are in flight beyond the
    answers the caller holds.
    """
    _check_args(out, transport)
    mesh = as_mesh(device)
    profiling.follow_profiler()

    def start(fut, root):
        profiling.follow_profiler()
        with profiling.within(root):
            with profiling.span("lrf.decode.inflate_wait", mirror=True):
                staged = fut.result()
            return root, staged, _device_start(*staged, mesh, out)

    def finish(root, staged, started):
        profiling.follow_profiler()
        with profiling.within(root):
            pixels = _device_decode(started, *staged[1:], mesh, out)
        profiling.end(root)
        return pixels

    on_device = None  # the batch whose pixels are on their way to the host

    def advance(inflating):
        """Start `inflating`'s device stage, then finish the batch before it."""
        nonlocal on_device
        previous, on_device = on_device, start(*inflating)
        if previous is not None:
            yield finish(*previous)

    with ThreadPoolExecutor(max_workers=1) as pool:
        inflating = None
        for seq, streams in enumerate(stream_batches):
            profiling.follow_profiler()
            root = profiling.begin("lrf.decode.batch", batch=seq)
            fut = pool.submit(_inflate_spanned, streams, mesh.size == 1, transport, root)
            if inflating is not None:
                yield from advance(inflating)
            inflating = (fut, root)
        if inflating is not None:
            yield from advance(inflating)
        if on_device is not None:
            yield finish(*on_device)
