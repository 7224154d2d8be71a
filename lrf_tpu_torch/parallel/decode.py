"""Batched QMF decode of homogeneous streams on one device.

Port of `lrf_tpu/parallel/decode.py` (its flat upload; the delta+Huffman
upload is not ported yet). The host parses every stream, inflates all
fibers and bit-packs the factor values for the upload in fused native
passes (`_inflate_pack_native`: `lrf_decompress_fibers`, then
`lrf_pack_values`, `30 // bits` values per word); the six factor arrays
travel to the device as ONE `(B, words)` buffer and are unpacked and
sliced there. The reconstruction (U V^T per channel, depatchify, unpad,
nearest chroma upsample, YCbCr -> RGB, clamp-cast) runs batched.
Per-image results equal `lrf_tpu_torch.qmf_decode`'s.
`sharded_qmf_decode_batches` overlaps the host stage of the next batch
with the device work of the current one.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lrf_tpu_torch.models.container import bytes_to_dict, decode_matrix_batch, separate_bytes
from lrf_tpu_torch.native import fibercodec as _native
from lrf_tpu_torch.ops.color import ycbcr_to_rgb
from lrf_tpu_torch.ops.pad import unpad_image
from lrf_tpu_torch.ops.patch import depatchify
from lrf_tpu_torch.ops.quantize import torch_dtype, to_dtype
from lrf_tpu_torch.ops.resample import chroma_upsample
from lrf_tpu_torch.parallel.encode import _pack_params
from lrf_tpu_torch.utils.transfer import resolve_device, to_host

__all__ = ["sharded_qmf_decode_batch", "sharded_qmf_decode_batches"]

# Per-config (metadata signature) bit-pack decisions: the first batch of a
# config decides whether its uploads are packed; see _inflate_streams.
_PACK_DECISIONS: dict = {}


def _inflate_streams(streams):
    """Host stage: parse containers, inflate all fibers, pack the upload.

    Touches no torch state, so it runs on a worker thread beside device
    work. Returns `(flat, metadata, shapes, in_dtype, pack)`: the upload
    buffer (`(B, words)` uint32 when `pack` is `(lo, bits, total)`, else the
    `(B, total)` factor values), the shared metadata, the per-factor
    `(M, R)` shapes and the factors' dtype name.
    """
    if len(streams) == 0:
        raise ValueError("no streams to decode")
    metadata = None
    per_factor: list[list[bytes]] = [[] for _ in range(6)]
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
    fast = _inflate_pack_native(per_factor, metadata, b)
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


def _inflate_pack_native(per_factor, metadata, b: int):
    """Fused native inflate + bit-pack of int8 column-fiber factors.

    Inflates each factor's fibers to its raw fiber-major buffer and packs
    them straight into the `(B, words)` upload (`lrf_pack_values`). Returns
    `_inflate_streams`' tuple, or None for the numpy route: no bounds, 8 or
    more bits, a non-int8 or row-fiber factor, a cached unpacked decision,
    or a value outside the bounds (the native pass doubles as that check).
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
    packed = _native.pack_values(raws, b, [m for m, _ in shapes], [r for _, r in shapes], lo, bits)
    if packed is None:  # a value outside the bounds: unpacked upload
        _PACK_DECISIONS.setdefault(config_key, False)
        return None
    _PACK_DECISIONS.setdefault(config_key, True)
    return packed, metadata, tuple(shapes), "int8", (lo, bits, sum(m * r for m, r in shapes))


def _reconstruct(flat: torch.Tensor, metadata, shapes, in_dtype: str = "int8", pack=None) -> torch.Tensor:
    """Upload buffer on the device -> `(B, 3, H, W)` images.

    With `pack = (lo, bits, total)`, `flat` is the `(B, words)` packed
    buffer as int32 (words stay below 2^30), unpacked here with shifts and
    masks; else it is the `(B, total)` factor values.
    """
    if pack is not None:
        lo, bits, total = pack
        vals_per_word = 30 // bits
        shifts = torch.arange(vals_per_word, dtype=torch.int32, device=flat.device) * bits
        vals = (flat[:, :, None] >> shifts) & ((1 << bits) - 1)
        flat = (vals.reshape(flat.shape[0], -1)[:, :total] + lo).to(torch_dtype(in_dtype))
    orig_sizes = [tuple(s) for s in metadata["original size"]]
    padded_sizes = [tuple(s) for s in metadata["padded size"]]
    patch_size = tuple(metadata["patch size"])
    factors = []
    offset = 0
    for m, r in shapes:
        factors.append(flat[:, offset : offset + m * r].reshape(-1, m, r).to(torch.float32))
        offset += m * r
    ycbcr = []
    for i in range(3):
        x = torch.matmul(factors[2 * i], factors[2 * i + 1].transpose(-1, -2))
        channel = depatchify(x, padded_sizes[i], patch_size)
        ycbcr.append(unpad_image(channel, orig_sizes[i]))
    image = chroma_upsample(tuple(ycbcr), size=orig_sizes[0], mode="nearest")
    return to_dtype(ycbcr_to_rgb(image), metadata["dtype"])


def _device_decode(flat: np.ndarray, metadata, shapes, in_dtype, pack, device, out: str):
    if pack is not None:
        flat = flat.view(np.int32)
    images = _reconstruct(torch.from_numpy(flat).to(device), metadata, shapes, in_dtype, pack)
    return images if out == "device" else to_host(images)


def sharded_qmf_decode_batch(streams, device="cuda", out: str = "host"):
    """Decode homogeneous YCbCr-patch QMF streams as one batch on `device`.

    Returns a `(B, 3, H, W)` array of the original dtype: numpy when
    ``out="host"``, the tensor on `device` when ``out="device"``.
    """
    if out not in ("host", "device"):
        raise ValueError("out must be 'host' or 'device'")
    device = resolve_device(device)
    return _device_decode(*_inflate_streams(streams), device, out)


def sharded_qmf_decode_batches(stream_batches, device="cuda", out: str = "host"):
    """Pipelined decode of a sequence of homogeneous stream batches.

    Generator yielding one decoded `(B, 3, H, W)` array per input batch, in
    order. The host stage of batch i+1 (parse, native inflate and pack, on
    a worker thread, no torch state) overlaps the upload and reconstruction
    of batch i on the calling thread, where all torch work stays.
    """
    if out not in ("host", "device"):
        raise ValueError("out must be 'host' or 'device'")
    device = resolve_device(device)
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = None
        for streams in stream_batches:
            fut = pool.submit(_inflate_streams, streams)
            if pending is not None:
                yield _device_decode(*pending.result(), device, out)
            pending = fut
        if pending is not None:
            yield _device_decode(*pending.result(), device, out)
