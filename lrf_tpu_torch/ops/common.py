"""Small numeric helpers shared by the factorization code.

PyTorch port of `lrf_tpu/ops/common.py:12-34`: the same functions on
tensors, broadcasting over leading batch dimensions.
"""

from __future__ import annotations

import torch


def prod(x) -> int:
    """Product of an iterable of ints."""
    out = 1
    for v in x:
        out *= v
    return out


def relative_error(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
    """Frobenius relative error over the last two dims."""
    num = torch.sqrt(torch.sum((x - y) ** 2, dim=(-2, -1)))
    den = torch.sqrt(torch.sum(x**2, dim=(-2, -1)))
    return num / (den + eps)


def safe_divide(num: torch.Tensor, den: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
    """Division with a sign-preserving epsilon guard on the denominator."""
    small = torch.abs(den) < eps
    adjusted = torch.where(small, eps * torch.sign(den), den)
    return num / adjusted


def soft_thresholding(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """Soft-threshold operator; identity at 0."""
    if threshold == 0:
        return x
    return torch.sign(x) * torch.clamp(torch.abs(x) - threshold, min=0.0)
