"""Batched QMF encode of same-size images on one device.

Port of `lrf_tpu/parallel/encode.py:239-454`, `:457-614` and `:617-659`
with a `device=` in place of the JAX mesh. A `(B, 3, H, W)` batch runs as
one batched pipeline: color transform, chroma downsample, pad, patchify,
then the factorization of each channel's `(B, M, N)` patch stack:

- Cb and Cr share shape and rank at every canonical config, so they are
  merged into ONE `(2B, M, N)` BCD batch;
- one batched eigh over all channels' `(N, N)` Grams initializes every
  stack (`svd_init_shared`), when every stack is tall (M >= N);
- the BCD loop goes through `lrf_tpu_torch.ops.bcd_kernel.bcd`: the CUDA
  kernel on a GPU, one launch for Y and one for the merged chroma.

The factors come back raw (int8) and are serialized on the host, image by
image, with the same container as `qmf_encode`. The flat and entropy
transport packs and the pipelined multi-batch encoder are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lrf_tpu_torch.models.container import combine_bytes, dict_to_bytes, encode_tensor_batch
from lrf_tpu_torch.models.qmf import _channel_ranks, _padded_size
from lrf_tpu_torch.ops.bcd import svd_init, svd_init_shared
from lrf_tpu_torch.ops.bcd_kernel import bcd, bcd_reference
from lrf_tpu_torch.ops.color import rgb_to_ycbcr
from lrf_tpu_torch.ops.pad import pad_image
from lrf_tpu_torch.ops.patch import patchify
from lrf_tpu_torch.ops.quantize import torch_dtype
from lrf_tpu_torch.ops.resample import chroma_downsample, scaled_size
from lrf_tpu_torch.utils.transfer import resolve_device, to_host

__all__ = ["build_sharded_encoder", "sharded_qmf_encode_batch"]

# "auto": `bcd` (the CUDA kernel on a GPU, the plain sweeps on the CPU);
# "torch": the plain PyTorch sweeps on any device (`bcd_reference`).
_BACKENDS = ("auto", "torch")


def _encoder(ranks, scale_factor, patch_size, bounds, num_iters, dtype, backend):
    """The batched encode function for one config: `(B, 3, H, W)` -> 6 factors."""
    run_bcd = bcd if backend == "auto" else bcd_reference

    def factorize(xm, rank, init):
        if init is None:
            init = svd_init(xm, rank, bounds=bounds)
        return run_bcd(xm, init[0], init[1], num_iters=num_iters, bounds=bounds)

    def encode(images: torch.Tensor):
        channels = chroma_downsample(rgb_to_ycbcr(images), scale_factor)
        stacks = [patchify(pad_image(c, patch_size), patch_size) for c in channels]
        if stacks[1].shape == stacks[2].shape and ranks[1] == ranks[2]:
            merged = torch.cat([stacks[1], stacks[2]], dim=0)
            if all(s.shape[-2] >= s.shape[-1] for s in (stacks[0], merged)):
                init_y, init_c = svd_init_shared([stacks[0], merged], [ranks[0], ranks[1]], bounds=bounds)
            else:
                init_y = init_c = None
            u_y, v_y = factorize(stacks[0], ranks[0], init_y)
            u_c, v_c = factorize(merged, ranks[1], init_c)
            b = stacks[1].shape[0]
            per_channel = [(u_y, v_y), (u_c[:b], v_c[:b]), (u_c[b:], v_c[b:])]
        else:
            per_channel = [factorize(xm, r, None) for xm, r in zip(stacks, ranks)]
        return tuple(f.to(dtype) for uv in per_channel for f in uv)

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
):
    """A batched YCbCr-patch encoder for one config on `device`.

    Returns `(encode_fn, metadata)`: `encode_fn(images)` maps a `(B, 3, H, W)`
    tensor on `device` to the 6 per-channel factor tensors `(B, ., R)`;
    `metadata` is the stream metadata every image of the batch shares.
    `backend`: "auto" (the BCD kernel on a GPU) or "torch" (plain sweeps).
    """
    if rank is None and quality is None:
        raise ValueError("Either 'rank' or 'quality' must be specified.")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {_BACKENDS}")
    device = resolve_device(device)
    size = tuple(image_size)
    patch_size = tuple(patch_size)
    chroma_size = scaled_size(size, scale_factor)
    ch_sizes = (size, chroma_size, chroma_size)
    ranks = _channel_ranks(ch_sizes, rank, quality, True, patch_size)
    metadata = {
        "dtype": "uint8",
        "color space": "YCbCr",
        "patch": True,
        "bounds": list(bounds),
        "patch size": list(patch_size),
        "original size": [list(s) for s in ch_sizes],
        "padded size": [_padded_size(s, patch_size) for s in ch_sizes],
        "rank": list(ranks),
    }
    fn = _encoder(
        ranks, tuple(scale_factor), patch_size, tuple(bounds), num_iters,
        torch_dtype(dtype), backend,
    )
    return fn, metadata


def _serialize_batch(host_factors, metadata, b: int) -> list[bytes]:
    """Per-image streams from the fetched `(B, ., R)` factor arrays."""
    encoded_metadata = dict_to_bytes(metadata)
    per_factor_blobs = [encode_tensor_batch(f) for f in host_factors]
    return [
        combine_bytes([encoded_metadata, combine_bytes([blobs[i] for blobs in per_factor_blobs])])
        for i in range(b)
    ]


def sharded_qmf_encode_batch(
    images,
    quality: Optional[float | tuple] = None,
    rank: Optional[int | tuple] = None,
    device="cuda",
    **config,
) -> list[bytes]:
    """Encode a `(B, 3, H, W)` uint8 batch into per-image QMF byte streams.

    On the CPU the streams are byte-identical to per-image
    `lrf_tpu_torch.qmf_encode`. On a GPU the BCD kernel sums in another
    order than the plain sweeps, so a small share of factor entries can
    differ at round() ties; every stream decodes with either package.
    """
    device = resolve_device(device)
    if isinstance(images, torch.Tensor):
        images = images.to(device)
    else:
        images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    b = int(images.shape[0])
    size = (int(images.shape[-2]), int(images.shape[-1]))
    fn, metadata = build_sharded_encoder(device, size, quality=quality, rank=rank, **config)
    host = [to_host(f) for f in fn(images)]
    return _serialize_batch(host, metadata, b)
