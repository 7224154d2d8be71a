"""SVD image codec (the baseline): truncated SVD and uniform quantization.

Port of `lrf_tpu/models/svd.py`: the QMF framework, but the factors are
the sqrt(s)-balanced truncated-SVD factors (LAPACK's `?gesdd`, below),
min/max-quantized to the target integer dtype with `(scale, min)` in the
metadata. The container and metadata keys are the JAX package's and the
reference's, so streams decode in either package.

The YCbCr branch is the JAX package's repair of the reference's broken one
(a scalar rank per channel, one padded-size entry per channel); its
no-patch decode restores the channel dim the reference's would drop.

One `(scale, min)` quantizes all of U with a truncating cast, so each
component's sign moves every quantized value. The codec therefore factors
through LAPACK's `?gesdd` on the host (`ops/svd.py::_lapack_svd`, scipy)
on every device, as the HOSVD codecs take LAPACK's `?syevd`: that routine
is the JAX package's CPU `svd`, so the signs are the JAX package's, and the
card's streams are the CPU's wherever their X is. The factors go back to
the caller's device, and the quantizer runs there. `torch.linalg.svd` would
take its own LAPACK's signs on the CPU and cuSOLVER's on the card.
Float-factor streams (`dtype=np.float32`) decode to the same pixels
whatever the signs.
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
from lrf_tpu_torch.models.qmf import _as_tensor, _padded_size, _patched_mat_size, _rank_from_quality
from lrf_tpu_torch.ops.color import rgb_to_ycbcr, ycbcr_to_rgb
from lrf_tpu_torch.ops.pad import pad_image, unpad_image
from lrf_tpu_torch.ops.patch import depatchify, patchify
from lrf_tpu_torch.ops.quantize import _jitted_quantize, np_dequantize, to_dtype
from lrf_tpu_torch.ops.resample import chroma_downsample, chroma_upsample
from lrf_tpu_torch.ops.svd import _lapack_svd, pad_rank
from lrf_tpu_torch.utils.transfer import resolve_device, to_host

__all__ = ["svd_encode", "svd_decode", "svd_rank", "svd_compression_ratio"]


def svd_rank(size: tuple[int, int], com_ratio: float) -> int:
    """Rank for a target compression ratio."""
    num_rows, num_cols = size
    return max(math.floor(num_rows * num_cols / (com_ratio * (num_rows + num_cols))), 1)


def svd_compression_ratio(size: tuple[int, int], rank: int) -> float:
    """Compression ratio of a given rank."""
    num_rows, num_cols = size
    return (num_rows * num_cols) / (rank * (num_rows + num_cols))


def _balanced_factors(x: torch.Tensor, rank: int):
    """sqrt(s)-balanced truncated-SVD factors `x ~ u @ v.T` by the host's
    LAPACK (`_lapack_svd`), zero-padded on the rank axis up to `rank`, as
    `svd_balanced_factors` gives them."""
    r = min(rank, x.shape[-2], x.shape[-1])
    u, s, vh = _lapack_svd(x)
    rs = torch.sqrt(s[..., :r])[..., None, :]
    return pad_rank(u[..., :, :r] * rs, vh.transpose(-1, -2)[..., :, :r] * rs, rank)


def _encode_channel(x: torch.Tensor, rank: int, patch: bool, patch_size, qdtype: Optional[np.dtype]):
    """Host `(u, v)` and their `[scale, min]` pairs (None for float factors)."""
    x = x.to(torch.float32)
    xm = patchify(pad_image(x, patch_size), patch_size) if patch else x
    u, v = _balanced_factors(xm, rank)
    if qdtype is None:
        return to_host(u), to_host(v), None, None
    qu, su, mu = _jitted_quantize(u, qdtype)
    qv, sv, mv = _jitted_quantize(v, qdtype)
    return to_host(qu), to_host(qv), [float(su), float(mu)], [float(sv), float(mv)]


def svd_encode(
    image,
    rank: Optional[int | tuple[int, int, int]] = None,
    quality: Optional[float | tuple[float, float, float]] = None,
    color_space: str = "RGB",
    scale_factor: tuple[float, float] = (0.5, 0.5),
    patch: bool = True,
    patch_size: tuple[int, int] = (8, 8),
    dtype=None,
    device="cuda",
) -> bytes:
    """SVD compression of a `(3, H, W)` image to bytes, computed on `device`.

    Defaults are the reference's: RGB, 8x8 patches, and the image's own
    dtype as the quantization target when `dtype` is None (a float dtype
    keeps float32 factors).
    """
    if (rank, quality) == (None, None):
        raise ValueError("Either 'rank' or 'quality' must be specified.")
    device = resolve_device(device)
    image, image_dtype = _as_tensor(image, device)
    qdtype = np.dtype(image_dtype if dtype is None else dtype)
    qdtype = None if np.issubdtype(qdtype, np.floating) else qdtype
    size = (int(image.shape[-2]), int(image.shape[-1]))
    patch_size = tuple(patch_size)
    metadata = {"dtype": image_dtype, "color space": color_space, "patch": patch}

    if color_space == "RGB":
        if patch:
            mat_size = _patched_mat_size(size, patch_size, channels=3)
            metadata.update(
                {
                    "patch size": list(patch_size),
                    "original size": list(size),
                    "padded size": _padded_size(size, patch_size),
                }
            )
        else:
            mat_size = size
        r = _rank_from_quality(mat_size, quality) if rank is None else rank
        u, v, qtz_u, qtz_v = _encode_channel(image, r, patch, patch_size, qdtype)
        metadata["quantization"] = {"u": qtz_u, "v": qtz_v}
        factors = [u, v]
    else:
        if not isinstance(rank, Iterable):
            rank = (None,) * 3 if rank is None else (rank, max(rank // 2, 1), max(rank // 2, 1))
        if not isinstance(quality, Iterable):
            quality = (None,) * 3 if quality is None else (quality, quality / 2, quality / 2)
        channels = chroma_downsample(rgb_to_ycbcr(image.to(torch.float32)), tuple(scale_factor))
        if patch:
            metadata["patch size"] = list(patch_size)
        metadata["original size"] = []
        if patch:
            metadata["padded size"] = []
        metadata["rank"] = []
        metadata["quantization"] = {"u": [], "v": []}
        factors = []
        for channel, r_i, q_i in zip(channels, rank, quality):
            ch_size = (int(channel.shape[-2]), int(channel.shape[-1]))
            if patch:
                mat_size = _patched_mat_size(ch_size, patch_size)
                metadata["padded size"].append(_padded_size(ch_size, patch_size))
            else:
                mat_size = ch_size
            r = _rank_from_quality(mat_size, q_i) if r_i is None else r_i
            metadata["original size"].append(list(ch_size))
            metadata["rank"].append(r)
            u, v, qtz_u, qtz_v = _encode_channel(channel if patch else channel[0], r, patch, patch_size, qdtype)
            metadata["quantization"]["u"].append(qtz_u)
            metadata["quantization"]["v"].append(qtz_v)
            factors += [u, v]

    encoded_factors = combine_bytes([encode_tensor(f) for f in factors])
    return combine_bytes([dict_to_bytes(metadata), encoded_factors])


def _factor(raw: np.ndarray, qtz, device: torch.device) -> torch.Tensor:
    f = raw.astype(np.float32) if qtz is None else np_dequantize(raw, *qtz)
    return torch.from_numpy(np.ascontiguousarray(f)).to(device)


def _product(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.matmul(u, v.transpose(-1, -2))


def svd_decode(encoded_image: bytes, device="cuda") -> np.ndarray:
    """Decode an SVD stream to a `(3, H, W)` numpy array, computed on `device`."""
    device = resolve_device(device)
    encoded_metadata, encoded_factors = separate_bytes(encoded_image, 2)
    metadata = bytes_to_dict(encoded_metadata)
    out_dtype = metadata["dtype"]
    qtz = metadata["quantization"]

    if metadata["color space"] == "RGB":
        u, v = (decode_tensor(b) for b in separate_bytes(encoded_factors, 2))
        image = _product(_factor(u, qtz["u"], device), _factor(v, qtz["v"], device))
        if metadata["patch"]:
            image = depatchify(image, tuple(metadata["padded size"]), tuple(metadata["patch size"]))
            image = unpad_image(image, tuple(metadata["original size"]))
        return to_host(to_dtype(image, out_dtype))

    raw = [decode_tensor(b) for b in separate_bytes(encoded_factors, 6)]
    orig_sizes = [tuple(s) for s in metadata["original size"]]
    ycbcr = []
    for i in range(3):
        x = _product(_factor(raw[2 * i], qtz["u"][i], device), _factor(raw[2 * i + 1], qtz["v"][i], device))
        if metadata["patch"]:
            channel = depatchify(x, tuple(metadata["padded size"][i]), tuple(metadata["patch size"]))
            channel = unpad_image(channel, orig_sizes[i])
        else:
            channel = x[None]  # the no-patch factors are 2-D
        ycbcr.append(channel)
    image = chroma_upsample(tuple(ycbcr), size=orig_sizes[0], mode="area")
    return to_host(to_dtype(ycbcr_to_rgb(image), out_dtype))
