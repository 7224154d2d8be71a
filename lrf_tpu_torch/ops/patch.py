"""Patch reshapers: image <-> stacked flattened patches.

PyTorch port of `lrf_tpu/ops/patch.py:21-46`:

- `patchify`:  ``c (h p) (w q) -> (h w) (c p q)``
- `depatchify`: its inverse

Batch dimensions broadcast on the left.
"""

from __future__ import annotations

import torch


def patchify(x: torch.Tensor, patch_size: tuple[int, int]) -> torch.Tensor:
    """`(..., C, H, W) -> (..., H/p * W/q, C*p*q)` stacked flattened patches."""
    p, q = patch_size
    *b, c, hh, ww = x.shape
    h, w = hh // p, ww // q
    x = x.reshape(*b, c, h, p, w, q)
    nd = len(b)
    perm = tuple(range(nd)) + (nd + 1, nd + 3, nd, nd + 2, nd + 4)
    return x.permute(perm).reshape(*b, h * w, c * p * q)


def depatchify(
    x: torch.Tensor, size: tuple[int, int], patch_size: tuple[int, int]
) -> torch.Tensor:
    """Inverse of `patchify`; `size` is the (padded) image (H, W)."""
    p, q = patch_size
    *b, hw, cpq = x.shape
    h, w = size[0] // p, size[1] // q
    c = cpq // (p * q)
    x = x.reshape(*b, h, w, c, p, q)
    nd = len(b)
    perm = tuple(range(nd)) + (nd + 2, nd, nd + 3, nd + 1, nd + 4)
    return x.permute(perm).reshape(*b, c, h * p, w * q)
