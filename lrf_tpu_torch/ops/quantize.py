"""Clamp-casts between float tensors and integer codec dtypes.

PyTorch port of `lrf_tpu/ops/quantize.py:16-42` (`dtype_range`, `to_dtype`).
Dtypes may be given as numpy dtypes, their names or torch dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype for a numpy dtype, a dtype name or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def numpy_dtype(dtype) -> np.dtype:
    """numpy dtype for a torch dtype, a dtype name or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NP[dtype]
    return np.dtype(dtype)


def dtype_range(dtype) -> tuple[float, float]:
    """Representable (min, max) of `dtype`."""
    dtype = numpy_dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        info = np.finfo(dtype)
        return float(info.min), float(info.max)
    info = np.iinfo(dtype)
    return int(info.min), int(info.max)


def to_dtype(x: torch.Tensor, dtype) -> torch.Tensor:
    """Clamp to the representable range of `dtype`, then cast.

    The float->int cast truncates toward zero, as `lrf_tpu.ops.quantize.to_dtype`
    does.
    """
    lo, hi = dtype_range(dtype)
    return torch.clamp(x, lo, hi).to(torch_dtype(dtype))
