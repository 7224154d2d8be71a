"""QMF image codec, one image at a time.

Port of `lrf_tpu/models/qmf.py:47-351`: the same parameters, defaults,
quality -> rank schedule, metadata keys and container framing, so streams
decode in either package. The numeric pipeline (color transform, chroma
area-downsample, reflect pad, 8x8 patchify, SVD init + integer BCD, int8
cast) runs on `device`; only the int8 factors come back to the host.

Rank/quality semantics:
- scalar rank r -> (r, max(r//2,1), max(r//2,1)) for (Y, Cb, Cr)
- scalar quality q -> (q, q/2, q/2); R = max(round(min(M,N) * q/100), 1)
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch

from lrf_tpu_torch.models.container import (
    bytes_to_dict,
    combine_bytes,
    decode_tensor,
    dict_to_bytes,
    encode_tensor,
    separate_bytes,
)
from lrf_tpu_torch.ops.bcd import qmf_decompose, qmf_reconstruct
from lrf_tpu_torch.ops.color import rgb_to_ycbcr, ycbcr_to_rgb
from lrf_tpu_torch.ops.pad import pad_amounts, pad_image, unpad_image
from lrf_tpu_torch.ops.patch import depatchify, patchify
from lrf_tpu_torch.ops.quantize import numpy_dtype, to_dtype, torch_dtype
from lrf_tpu_torch.ops.resample import chroma_downsample, chroma_upsample, scaled_size
from lrf_tpu_torch.utils.transfer import resolve_device, to_host

__all__ = ["qmf_encode", "qmf_decode", "qmf_rank"]


def qmf_rank(size: tuple[int, int], com_ratio: float) -> int:
    """Rank for a target compression ratio."""
    num_rows, num_cols = size
    return max(math.floor(num_rows * num_cols / (com_ratio * (num_rows + num_cols))), 1)


def _rank_from_quality(mat_size: tuple[int, int], quality: float) -> int:
    """`R = max(round(min(M,N) * q / 100), 1)`."""
    if not 0 <= quality <= 100:
        raise ValueError("'quality' must be between 0 and 100.")
    return max(round(min(mat_size) * quality / 100), 1)


def _patched_mat_size(
    ch_size: tuple[int, int], patch_size: tuple[int, int], channels: int = 1
) -> tuple[int, int]:
    """`(num_patches, channels * p * q)` of the patchified, padded channel(s)."""
    t, b, l, r = pad_amounts(ch_size, patch_size)
    hp, wp = ch_size[0] + t + b, ch_size[1] + l + r
    p, q = patch_size
    return (hp // p) * (wp // q), channels * p * q


def _padded_size(ch_size, patch_size) -> list[int]:
    t, b, l, r = pad_amounts(ch_size, patch_size)
    return [ch_size[0] + t + b, ch_size[1] + l + r]


def _channel_ranks(ch_sizes, rank, quality, patch, patch_size) -> tuple[int, int, int]:
    """Per-channel (Y, Cb, Cr) ranks from a scalar or tuple rank/quality."""
    if not isinstance(rank, Iterable):
        rank = (None,) * 3 if rank is None else (rank, max(rank // 2, 1), max(rank // 2, 1))
    if not isinstance(quality, Iterable):
        quality = (None,) * 3 if quality is None else (quality, quality / 2, quality / 2)
    ranks = []
    for r, q, ch_size in zip(rank, quality, ch_sizes):
        if r is None:
            mat_size = _patched_mat_size(ch_size, patch_size) if patch else ch_size
            r = _rank_from_quality(mat_size, q)
        ranks.append(r)
    return tuple(ranks)


def _as_tensor(image, device: torch.device) -> tuple[torch.Tensor, str]:
    """Image as a tensor on `device`, and its dtype's numpy name."""
    if isinstance(image, torch.Tensor):
        return image.to(device), numpy_dtype(image.dtype).name
    arr = np.asarray(image)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device), arr.dtype.name


def qmf_encode(
    image,
    rank: Optional[int | tuple[int, int, int]] = None,
    quality: Optional[float | tuple[float, float, float]] = None,
    color_space: str = "YCbCr",
    scale_factor: tuple[float, float] = (0.5, 0.5),
    patch: bool = True,
    patch_size: tuple[int, int] = (8, 8),
    bounds: tuple[float, float] = (-16, 15),
    dtype=np.int8,
    num_iters: int = 10,
    device="cuda",
    **kwargs,
) -> bytes:
    """QMF compression of a `(3, H, W)` image to bytes, computed on `device`."""
    if (rank, quality) == (None, None):
        raise ValueError("Either 'rank' or 'quality' must be specified.")
    if color_space not in ("RGB", "YCbCr"):
        raise ValueError("`color_space` must be one of 'RGB' or 'YCbCr'.")
    device = resolve_device(device)
    image, image_dtype_name = _as_tensor(image, device)
    factor_dtype = torch_dtype(dtype)
    bounds = tuple(bounds)
    patch_size = tuple(patch_size) if patch else (8, 8)
    size = (int(image.shape[-2]), int(image.shape[-1]))
    kw = dict(num_iters=num_iters, bounds=bounds, factor=(0, 1), **kwargs)

    metadata = {
        "dtype": image_dtype_name,
        "color space": color_space,
        "patch": patch,
        "bounds": list(bounds),
    }
    factors = []
    if color_space == "RGB":
        if patch:
            mat_size = _patched_mat_size(size, patch_size, channels=3)
            r = _rank_from_quality(mat_size, quality) if rank is None else rank
            metadata.update(
                {
                    "patch size": list(patch_size),
                    "original size": list(size),
                    "padded size": _padded_size(size, patch_size),
                    "rank": r,
                }
            )
        else:
            r = _rank_from_quality(size, quality) if rank is None else rank
            metadata["rank"] = r
        x = image.to(torch.float32)
        xm = patchify(pad_image(x, patch_size), patch_size) if patch else x
        u, v, _ = qmf_decompose(xm, rank=r, **kw)
        factors = [u, v]
    else:
        chroma_size = scaled_size(size, scale_factor)
        ch_sizes = (size, chroma_size, chroma_size)
        ranks = _channel_ranks(ch_sizes, rank, quality, patch, patch_size)
        if patch:
            metadata["patch size"] = list(patch_size)
        metadata["original size"] = [list(s) for s in ch_sizes]
        if patch:
            metadata["padded size"] = [_padded_size(s, patch_size) for s in ch_sizes]
        metadata["rank"] = list(ranks)
        channels = chroma_downsample(rgb_to_ycbcr(image), tuple(scale_factor))
        for channel, r in zip(channels, ranks):
            # No-patch channels keep their leading singleton dim: factors stay
            # 3-D (1, H, R) and go through the whole-tensor coder.
            xm = patchify(pad_image(channel, patch_size), patch_size) if patch else channel
            u, v, _ = qmf_decompose(xm, rank=r, **kw)
            factors += [u, v]

    host = [to_host(f.to(factor_dtype)) for f in factors]
    encoded_factors = combine_bytes([encode_tensor(f) for f in host])
    return combine_bytes([dict_to_bytes(metadata), encoded_factors])


def _decode_channel(u, v, device) -> torch.Tensor:
    # np.array copies: inflated fibers are read-only buffers.
    u = torch.from_numpy(np.array(u)).to(device).to(torch.float32)
    v = torch.from_numpy(np.array(v)).to(device).to(torch.float32)
    return qmf_reconstruct(u, v)


def qmf_decode(encoded_image: bytes, device="cuda") -> np.ndarray:
    """Decode a QMF stream to a `(3, H, W)` numpy array, computed on `device`."""
    device = resolve_device(device)
    encoded_metadata, encoded_factors = separate_bytes(encoded_image, 2)
    metadata = bytes_to_dict(encoded_metadata)
    out_dtype = metadata["dtype"]

    if metadata["color space"] == "RGB":
        u, v = (decode_tensor(b) for b in separate_bytes(encoded_factors, 2))
        image = _decode_channel(u, v, device)
        if metadata["patch"]:
            image = depatchify(image, tuple(metadata["padded size"]), tuple(metadata["patch size"]))
            image = unpad_image(image, tuple(metadata["original size"]))
        return to_host(to_dtype(image, out_dtype))

    factors = [decode_tensor(b) for b in separate_bytes(encoded_factors, 6)]
    orig_sizes = [tuple(s) for s in metadata["original size"]]
    ycbcr = []
    for i in range(3):
        channel = _decode_channel(factors[2 * i], factors[2 * i + 1], device)
        if metadata["patch"]:
            channel = depatchify(channel, tuple(metadata["padded size"][i]), tuple(metadata["patch size"]))
            channel = unpad_image(channel, orig_sizes[i])
        ycbcr.append(channel)
    image = chroma_upsample(tuple(ycbcr), size=orig_sizes[0], mode="nearest")
    return to_host(to_dtype(ycbcr_to_rgb(image), out_dtype))
