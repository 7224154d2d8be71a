"""Quality and rate metrics: port of `lrf_tpu/utils/metrics.py`.

- `mae`, `mse`, `relative_error` and `psnr` cast their inputs to float32
  (integer subtraction would wrap) and reduce over the last three dims.
- `ssim` re-implements skimage's `structural_similarity` with the
  reference's settings, as the JAX package does: a 7x7 uniform window,
  sample covariance (49/48), K1 = 0.01 and K2 = 0.03, `data_range` from
  the first image, the mean over channels. Only windows wholly inside the
  image count (skimage crops the rest), so the filter is a valid-mode mean
  pool and the edge mode does not matter.
- `get_memory_usage`, `compression_ratio` and `bits_per_pixel` count the
  bytes of tensors, arrays, `bytes` and containers of them.

Array inputs (numpy or array-likes) are copied into CPU tensors; tensors
are used on their own device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = [
    "mae",
    "mse",
    "relative_error",
    "psnr",
    "ssim",
    "get_memory_usage",
    "compression_ratio",
    "bits_per_pixel",
]


def _as_float(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.ascontiguousarray(x))
    return x.to(torch.float32)


def mae(x, y) -> torch.Tensor:
    """Mean absolute error over the last three dims."""
    x, y = _as_float(x), _as_float(y)
    return torch.mean(torch.abs(x - y), dim=(-3, -2, -1))


def mse(x, y) -> torch.Tensor:
    """Mean squared error over the last three dims."""
    x, y = _as_float(x), _as_float(y)
    return torch.mean((x - y) ** 2, dim=(-3, -2, -1))


def relative_error(x, y, epsilon: float = 1e-16) -> torch.Tensor:
    """Relative L2 error `||x - y|| / (||x|| + eps)` over the last three dims."""
    x, y = _as_float(x), _as_float(y)
    num = torch.sqrt(torch.sum((x - y) ** 2, dim=(-3, -2, -1)))
    den = torch.sqrt(torch.sum(x**2, dim=(-3, -2, -1)))
    return num / (den + epsilon)


def psnr(img1, img2, max_value: float = 255.0) -> torch.Tensor:
    """`20 log10(max / sqrt(mse))`."""
    return 20.0 * torch.log10(max_value / torch.sqrt(mse(img1, img2)))


def _valid_mean_pool(x: torch.Tensor, win: int) -> torch.Tensor:
    """Valid-mode `win x win` mean filter of `(C, H, W)`, per channel."""
    return torch.nn.functional.avg_pool2d(x[:, None], win, stride=1)[:, 0]


def ssim(img1, img2, win: int = 7) -> torch.Tensor:
    """SSIM of two `(C, H, W)` images, as the reference's skimage call.

    `data_range` is `img1.max() - img1.min()`, taken from the first image
    as the reference does. Runs on `img1`'s device when it is a tensor.
    """
    x = _as_float(img1)
    y = _as_float(img2).to(x.device)
    data_range = x.max() - x.min()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    n = win * win
    cov_norm = n / (n - 1.0)  # sample covariance, as in skimage
    ux = _valid_mean_pool(x, win)
    uy = _valid_mean_pool(y, win)
    uxx = _valid_mean_pool(x * x, win)
    uyy = _valid_mean_pool(y * y, win)
    uxy = _valid_mean_pool(x * y, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return torch.mean(s, dim=(-2, -1)).mean()


def get_memory_usage(obj: Any) -> int:
    """Bytes of tensors, numpy arrays and `bytes`, summed through lists,
    tuples, sets and dict values."""
    if isinstance(obj, (list, tuple, set)):
        return sum(get_memory_usage(o) for o in obj)
    if isinstance(obj, dict):
        return sum(get_memory_usage(o) for o in obj.values())
    if isinstance(obj, bytes):
        return len(obj)
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    raise ValueError("Unsupported data type: provide arrays, bytes, or containers thereof.")


def compression_ratio(input: Any, compressed: Any) -> float:
    """`input bytes / compressed bytes`."""
    return get_memory_usage(input) / get_memory_usage(compressed)


def bits_per_pixel(size, compressed: Any) -> float:
    """`compressed bytes * 8 / prod(size)`."""
    return get_memory_usage(compressed) * 8 / int(np.prod(size))
