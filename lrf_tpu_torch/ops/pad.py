"""Reflect padding to patch multiples, and its centered-crop inverse.

PyTorch port of `lrf_tpu/ops/pad.py:15-37`. The reflect pad is a gather
whose indices come from `np.pad(arange(n), mode="reflect")`, so it matches
`jnp.pad(mode="reflect")` for every size, including pads wider than the
image.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_amounts(size: tuple[int, int], patch_size: tuple[int, int]):
    """(top, bottom, left, right) padding; the extra pixel goes bottom/right."""
    h, w = size
    p, q = patch_size
    pad_h = (p - h % p) % p
    pad_w = (q - w % q) % q
    top = pad_h // 2
    left = pad_w // 2
    return top, pad_h - top, left, pad_w - left


def _reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    idx = np.pad(np.arange(n, dtype=np.int64), (before, after), mode="reflect")
    return torch.from_numpy(idx).to(device)


def pad_image(x: torch.Tensor, patch_size: tuple[int, int]) -> torch.Tensor:
    """Reflect-pad `(..., H, W)` so H, W become multiples of `patch_size`."""
    top, bottom, left, right = pad_amounts((x.shape[-2], x.shape[-1]), patch_size)
    if (top, bottom, left, right) == (0, 0, 0, 0):
        return x
    x = torch.index_select(x, x.ndim - 2, _reflect_index(x.shape[-2], top, bottom, x.device))
    return torch.index_select(x, x.ndim - 1, _reflect_index(x.shape[-1], left, right, x.device))


def unpad_image(x: torch.Tensor, orig_size: tuple[int, int]) -> torch.Tensor:
    """Centered crop back to `orig_size`."""
    h_pad, w_pad = x.shape[-2], x.shape[-1]
    h, w = orig_size
    start_h = (h_pad - h) // 2
    start_w = (w_pad - w) // 2
    return x[..., start_h : start_h + h, start_w : start_w + w]
