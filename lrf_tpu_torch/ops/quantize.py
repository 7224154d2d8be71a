"""Uniform affine quantization and clamp-casts.

PyTorch port of `lrf_tpu/ops/quantize.py`: `dtype_range`, `to_dtype`,
`quantize`, `dequantize` and `np_dequantize`. Dtypes may be given as numpy
dtypes, their names or torch dtypes.

`dequantize` keeps the reference's quirk: it subtracts the quantized
tensor's observed minimum, not the dtype's `qmin`. The SVD codec's streams
rely on it.
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


def quantize(x: torch.Tensor, target_dtype):
    """Uniform min/max quantization to `target_dtype`'s full range.

    ``q = clamp((x - min) / scale + qmin, qmin, qmax).to(dtype)`` with
    ``scale = (max - min) / (qmax - qmin)``, all in float32 like the JAX
    package's 0-d arrays (the SVD codec writes `float(scale)` into its
    metadata). Returns `(q, scale, min_val)`, the last two 0-d tensors.
    The divisor is a tensor on x's device: the card divides by a Python
    scalar as a product with its reciprocal, which can move the last bit.
    """
    qmin, qmax = dtype_range(target_dtype)
    x = x.to(torch.float32)
    min_val = torch.amin(x)
    scale = (torch.amax(x) - min_val) / torch.tensor(float(qmax - qmin), device=x.device)
    return _levels(x, scale, min_val, qmin, qmax, target_dtype), scale, min_val


def _jitted_quantize(x: torch.Tensor, target_dtype):
    """`quantize` as XLA compiles it inside the JAX package's jitted SVD
    codec (`lrf_tpu/models/svd.py::_svd_core`): there the division by the
    constant ``qmax - qmin`` becomes a product with its float32 reciprocal,
    which moves the scale's last bit in most factors. The same bits on
    every device."""
    qmin, qmax = dtype_range(target_dtype)
    x = x.to(torch.float32)
    min_val = torch.amin(x)
    recip = torch.tensor(np.float32(1.0) / np.float32(qmax - qmin), device=x.device)
    scale = (torch.amax(x) - min_val) * recip
    return _levels(x, scale, min_val, qmin, qmax, target_dtype), scale, min_val


def _levels(x, scale, min_val, qmin, qmax, target_dtype) -> torch.Tensor:
    return torch.clamp((x - min_val) / scale + qmin, qmin, qmax).to(torch_dtype(target_dtype))


def dequantize(q: torch.Tensor, scale, min_val) -> torch.Tensor:
    """Inverse of `quantize`, with `q - q.min()` (the observed minimum)."""
    qf = q.to(torch.float32)
    return (qf - torch.amin(qf)) * scale + min_val


def np_dequantize(q: np.ndarray, scale: float, min_val: float) -> np.ndarray:
    """`dequantize` on numpy arrays, on the host (the decoders' form)."""
    qf = q.astype(np.float32)
    return (qf - qf.min()) * np.float32(scale) + np.float32(min_val)
