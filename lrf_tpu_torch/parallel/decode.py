"""Batched QMF decode of homogeneous streams on one device.

Port of `lrf_tpu/parallel/decode.py:61-151`. The host parses every stream
and inflates its fibers (`decode_matrix_batch`); the six int8 factor arrays
travel to the device as ONE flat `(B, total)` upload and are sliced there;
the reconstruction (U V^T per channel, depatchify, unpad, nearest chroma
upsample, YCbCr -> RGB, clamp-cast) runs batched. Per-image results equal
`lrf_tpu_torch.qmf_decode`'s.
"""

from __future__ import annotations

import numpy as np
import torch

from lrf_tpu_torch.models.container import bytes_to_dict, decode_matrix_batch, separate_bytes
from lrf_tpu_torch.ops.color import ycbcr_to_rgb
from lrf_tpu_torch.ops.pad import unpad_image
from lrf_tpu_torch.ops.patch import depatchify
from lrf_tpu_torch.ops.quantize import to_dtype
from lrf_tpu_torch.ops.resample import chroma_upsample
from lrf_tpu_torch.utils.transfer import resolve_device, to_host

__all__ = ["sharded_qmf_decode_batch"]


def _inflate_streams(streams):
    """Host stage: parse containers and inflate all fibers.

    Returns the flat batch-major `(B, total)` factor buffer, the shared
    metadata and the per-factor `(M, R)` shapes.
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
                    "batched decode covers the YCbCr+patch format; use qmf_decode "
                    "for RGB/no-patch streams"
                )
        elif md != metadata:
            raise ValueError("streams must share one codec config")
        for k, blob in enumerate(separate_bytes(encoded_factors, 6)):
            per_factor[k].append(blob)
    b = len(streams)
    factors = [decode_matrix_batch(blobs) for blobs in per_factor]
    flat = np.concatenate([f.reshape(b, -1) for f in factors], axis=1)
    return flat, metadata, tuple(f.shape[1:] for f in factors)


def _reconstruct(flat: torch.Tensor, metadata, shapes) -> torch.Tensor:
    """`(B, total)` factor buffer on the device -> `(B, 3, H, W)` images."""
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


def sharded_qmf_decode_batch(streams, device="cuda", out: str = "host"):
    """Decode homogeneous YCbCr-patch QMF streams as one batch on `device`.

    Returns a `(B, 3, H, W)` array of the original dtype: numpy when
    ``out="host"``, the tensor on `device` when ``out="device"``.
    """
    if out not in ("host", "device"):
        raise ValueError("out must be 'host' or 'device'")
    device = resolve_device(device)
    flat, metadata, shapes = _inflate_streams(streams)
    images = _reconstruct(torch.from_numpy(flat).to(device), metadata, shapes)
    return images if out == "device" else to_host(images)
