"""Patch reshapers: image <-> stacked flattened patches.

PyTorch port of `lrf_tpu/ops/patch.py`:

- `patchify`:  ``c (h p) (w q) -> (h w) (c p q)``
- `depatchify`: its inverse
- `patchify_uv` / `depatchify_uv`: factor maps <-> factor matrices, for
  viewing QMF components.

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


def patchify_uv(u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor maps -> factor matrices: u `(R, 1, h, w) -> (h*w, R)`,
    v `(R, C, p, q) -> (C*p*q, R)`."""
    r, _, h, w = u.shape
    rv, c, p, q = v.shape
    return u.reshape(r, h * w).T, v.reshape(rv, c * p * q).T


def depatchify_uv(
    u: torch.Tensor, v: torch.Tensor, size: tuple[int, int], patch_size: tuple[int, int]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor matrices -> spatial factor maps: u `(h*w, R) -> (R, 1, h, w)`,
    v `(C*p*q, R) -> (R, C, p, q)`; `size` is the (padded) image (H, W)."""
    p, q = patch_size
    h = size[0] // p
    hw, r = u.shape
    cpq, rv = v.shape
    return u.T.reshape(r, 1, h, hw // h), v.T.reshape(rv, cpq // (p * q), p, q)
