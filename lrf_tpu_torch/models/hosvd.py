"""HOSVD (Tucker) codecs: whole-image and patch-HOSVD.

Port of `lrf_tpu/models/hosvd.py`. Like the JAX package and the reference,
these codecs give a dict of quantized arrays, not a framed stream. The dict
has the JAX package's keys, numpy types and dtypes (`(q, scale, min)`
tuples of a numpy array and two floats, or float32 arrays), so a dict made
by either package decodes in the other.

The rank-for-ratio solvers take the closed-form positive root of the
reference's quadratics (no sympy), as the JAX package does. The patch
codec's rank search scores every feasible r1 by SSIM against the input,
one host read of the score per candidate.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from lrf_tpu_torch.models.qmf import _as_tensor
from lrf_tpu_torch.ops.hosvd import hosvd, hosvd_rank_feasible_ranges, multi_mode_product
from lrf_tpu_torch.ops.pad import pad_image, unpad_image
from lrf_tpu_torch.ops.quantize import np_dequantize, quantize
from lrf_tpu_torch.utils.metrics import ssim
from lrf_tpu_torch.utils.transfer import resolve_device, to_host

__all__ = [
    "hosvd_rank",
    "hosvd_compression_ratio",
    "hosvd_encode",
    "hosvd_decode",
    "patch_hosvd_encode",
    "patch_hosvd_decode",
    "patch_hosvd_optimal_rank",
    "patch_hosvd_tensorize",
    "patch_hosvd_detensorize",
]


def _positive_quadratic_root(a: float, b: float, c: float) -> Optional[float]:
    """Smallest positive real root of a x^2 + b x + c = 0 (a > 0)."""
    disc = b * b - 4 * a * c
    if disc < 0:
        return None
    roots = [(-b - math.sqrt(disc)) / (2 * a), (-b + math.sqrt(disc)) / (2 * a)]
    pos = [r for r in roots if r > 0]
    return min(pos) if pos else None


def hosvd_rank(size: tuple[int, int, int], com_ratio: float):
    """Rank tuple `(c, r, r)` for a target compression ratio: the root of
    ``c*h*w = cr * (c*r^2 + c^2 + r*h + r*w)``."""
    c, h, w = size
    r = _positive_quadratic_root(com_ratio * c, com_ratio * (h + w), com_ratio * c * c - c * h * w)
    if r is None:
        raise ValueError("no feasible rank for this compression ratio")
    r = min(int(math.floor(r)), h, w)
    return c, r, r


def hosvd_compression_ratio(size: Sequence[int], rank) -> float:
    """Compression ratio of a rank tuple."""
    if isinstance(rank, int):
        rank = (rank,) * len(size)
    df_input = int(np.prod(size))
    df_core = int(np.prod(rank))
    df_factors = sum(s * r for s, r in zip(size, rank))
    return df_input / (df_core + df_factors)


def _to_unit_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1]; other dtypes -> float32."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def _pack(core: torch.Tensor, factors, dtype: np.dtype):
    """The dict's core and factors: `(q, scale, min)` per tensor, or float32
    arrays when `dtype` is float32."""
    if dtype == np.float32:
        return to_host(core), [to_host(f) for f in factors]

    def q(t):
        values, scale, min_val = quantize(t, dtype)
        return to_host(values), float(scale), float(min_val)

    return q(core), [q(f) for f in factors]


def _unpack(t, device: torch.device) -> torch.Tensor:
    if isinstance(t, tuple):
        t = np_dequantize(np.asarray(t[0]), t[1], t[2])
    return torch.from_numpy(np.array(t, dtype=np.float32)).to(device)


def hosvd_encode(
    x,
    rank: Optional[Sequence[int]] = None,
    com_ratio: Optional[float] = None,
    dtype=None,
    device="cuda",
) -> Dict:
    """Whole-image Tucker codec of a `(C, H, W)` image, computed on `device`."""
    if rank is None and com_ratio is None:
        raise ValueError("Either 'rank' or 'com_ratio' must be specified.")
    device = resolve_device(device)
    x, in_dtype = _as_tensor(x, device)
    dtype = np.dtype(in_dtype if dtype is None else dtype)
    if rank is None:
        rank = hosvd_rank(tuple(x.shape), com_ratio)
    core, factors = hosvd(_to_unit_float(x), rank=tuple(rank))
    core, factors = _pack(core, factors, dtype)
    return {"core": core, "factors": factors}


def hosvd_decode(encoded: Dict, dtype=np.uint8, device="cuda") -> np.ndarray:
    """Inverse of `hosvd_encode`: a uint8 `(C, H, W)` array."""
    device = resolve_device(device)
    core = _unpack(encoded["core"], device)
    factors = [_unpack(f, device) for f in encoded["factors"]]
    x = multi_mode_product(core, factors, transpose=False)
    return to_host(_to_uint8(torch.clamp(x, 0.0, 1.0)))


def patch_hosvd_tensorize(x: torch.Tensor, patch_size=(8, 8)) -> torch.Tensor:
    """`c (h p) (w q) -> (h w) p q c`."""
    p, q = patch_size
    c, hh, ww = x.shape
    h, w = hh // p, ww // q
    return x.reshape(c, h, p, w, q).permute(1, 3, 2, 4, 0).reshape(h * w, p, q, c)


def patch_hosvd_detensorize(x: torch.Tensor, size: tuple[int, int], patch_size=(8, 8)) -> torch.Tensor:
    """Inverse of `patch_hosvd_tensorize`."""
    p, q = patch_size
    h = size[0] // p
    hw, _, _, c = x.shape
    w = hw // h
    return x.reshape(h, w, p, q, c).permute(4, 0, 2, 1, 3).reshape(c, h * p, w * q)


def _optimal_rank(xf: torch.Tensor, com_ratio: float, patch_size):
    """`((r1, r2, r2, c), candidates scored, best SSIM)` of the rank search."""
    _, h, w = xf.shape
    tensor = patch_hosvd_tensorize(xf, patch_size)
    n, p, q, c = size = tuple(tensor.shape)
    (r1_min, r1_max), (_, r2_max), *_ = hosvd_rank_feasible_ranges(size, com_ratio, (None, None, None, c))
    df_input = int(np.prod(size))
    core, factors = hosvd(tensor, rank=(r1_max, r2_max, r2_max, c))
    best, scored = None, 0
    for r1 in range(r1_min, r1_max + 1):
        # df_core = r1 r2^2 c, df_factors = r1 n + r2 (p + q) + c^2
        r2 = _positive_quadratic_root(com_ratio * r1 * c, com_ratio * (p + q), com_ratio * (r1 * n + c * c) - df_input)
        if r2 is None:
            continue
        r2 = min(int(math.floor(r2)), p)
        if r2 < 1:
            continue
        recon = multi_mode_product(
            core[:r1, :r2, :r2, :], [factors[0][:, :r1], factors[1][:, :r2], factors[2][:, :r2], factors[3]]
        )
        score = float(ssim(xf, patch_hosvd_detensorize(recon, (h, w), patch_size)))
        scored += 1
        if best is None or score > best[0]:
            best = (score, r1, r2)
    if best is None:
        raise ValueError("rank search found no feasible (r1, r2)")
    score, r1, r2 = best
    return (r1, r2, r2, c), scored, score


def patch_hosvd_optimal_rank(x, com_ratio: float, patch_size=(8, 8), device="cuda"):
    """SSIM-driven `(r1, r2, r2, c)`: one HOSVD at the largest feasible
    ranks, then for each feasible r1 the closed-form r2 of the ratio's
    quadratic, each truncation scored by SSIM against the input."""
    x, _ = _as_tensor(x, resolve_device(device))
    return _optimal_rank(_to_unit_float(x), com_ratio, tuple(patch_size))[0]


def patch_hosvd_encode(
    x,
    rank: Optional[tuple[int, int, int, int]] = None,
    com_ratio: Optional[float] = None,
    bpp: Optional[float] = None,
    patch_size: tuple[int, int] = (8, 8),
    dtype=None,
    device="cuda",
) -> Dict:
    """Patch-HOSVD codec of a `(C, H, W)` image, computed on `device`."""
    if (rank, com_ratio, bpp) == (None, None, None):
        raise ValueError("Either 'rank', 'com_ratio', or 'bpp' must be specified.")
    device = resolve_device(device)
    x, in_dtype = _as_tensor(x, device)
    in_dtype = np.dtype(in_dtype)
    dtype = in_dtype if dtype is None else np.dtype(dtype)
    patch_size = tuple(patch_size)
    orig_size = (int(x.shape[-2]), int(x.shape[-1]))
    x = pad_image(x, patch_size)
    padded_size = (int(x.shape[-2]), int(x.shape[-1]))
    xf = _to_unit_float(x)
    if rank is None:
        if com_ratio is None:
            com_ratio = 8 * in_dtype.itemsize * int(x.shape[0]) / bpp
        rank = _optimal_rank(xf, com_ratio, patch_size)[0]
    core, factors = hosvd(patch_hosvd_tensorize(xf, patch_size), rank=tuple(rank))
    core, factors = _pack(core, factors, dtype)
    return {
        "core": core,
        "factors": factors,
        "original size": np.asarray(orig_size, np.int16),
        "padded size": np.asarray(padded_size, np.int16),
        "patch size": np.asarray(patch_size, np.uint8),
    }


def patch_hosvd_decode(encoded: Dict, dtype=np.uint8, device="cuda") -> np.ndarray:
    """Inverse of `patch_hosvd_encode`: a uint8 `(C, H, W)` array."""
    device = resolve_device(device)
    core = _unpack(encoded["core"], device)
    factors = [_unpack(f, device) for f in encoded["factors"]]
    orig_size = tuple(int(v) for v in np.asarray(encoded["original size"]))
    padded_size = tuple(int(v) for v in np.asarray(encoded["padded size"]))
    patch_size = tuple(int(v) for v in np.asarray(encoded["patch size"]))
    recon = multi_mode_product(core, factors, transpose=False)
    image = _to_uint8(torch.clamp(patch_hosvd_detensorize(recon, padded_size, patch_size), 0.0, 1.0))
    return to_host(unpad_image(image, orig_size))
