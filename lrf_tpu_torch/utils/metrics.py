"""Quality metrics: port of `lrf_tpu/utils/metrics.py:35-70` (`mse`, `psnr`).

Inputs are cast to float32 (integer subtraction would wrap) and reduced over
the last three dims. Array inputs (numpy or array-likes) are copied into CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mse", "psnr"]


def _as_float(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    return x.to(torch.float32)


def mse(x, y) -> torch.Tensor:
    """Mean squared error over the last three dims."""
    x, y = _as_float(x), _as_float(y)
    return torch.mean((x - y) ** 2, dim=(-3, -2, -1))


def psnr(img1, img2, max_value: float = 255.0) -> torch.Tensor:
    """`20 log10(max / sqrt(mse))`."""
    return 20.0 * torch.log10(max_value / torch.sqrt(mse(img1, img2)))
