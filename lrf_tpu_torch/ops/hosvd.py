"""Higher-order SVD (Tucker) and mode products.

PyTorch port of `lrf_tpu/ops/hosvd.py`: `unfold`, `mode_product` /
`multi_mode_product`, `hosvd` (per-mode truncated left singular vectors,
then the core), their batched forms over a leading batch dim, and the
rank-bound and feasible-range helpers of the codec's rank search.

Per-mode singular vectors come from `lrf_tpu_torch.ops.svd.truncated_svd`:
every unfolding is short x long, so it takes the eigh of the short-side
Gram. Eigenvector signs are the solver's, so factors may differ from the
JAX package's by the sign of a column; reconstructions do not.

The batched forms run the unbatched code with one leading batch dim
(`nbatch=1` below) rather than through `torch.func.vmap`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from lrf_tpu_torch.ops.common import prod
from lrf_tpu_torch.ops.svd import truncated_svd

__all__ = [
    "unfold",
    "mode_product",
    "multi_mode_product",
    "batched_multi_mode_product",
    "hosvd",
    "batched_hosvd",
    "hosvd_rank_upper_bounds",
    "hosvd_rank_feasible_ranges",
]


def hosvd_rank_upper_bounds(size: Sequence[int]) -> tuple[int, ...]:
    """Per-mode rank upper bounds: `min(size[i], prod(other sizes))`."""
    bounds = []
    for i, s in enumerate(size):
        other = prod(s for j, s in enumerate(size) if j != i)
        bounds.append(min(s, other))
    return tuple(bounds)


def hosvd_rank_feasible_ranges(
    size: Sequence[int],
    com_ratio: float,
    rank: Optional[Sequence[Optional[int]]] = None,
):
    """Feasible per-mode rank ranges for a target compression ratio.

    Per mode, a conservative lower bound that takes every other rank at
    its largest, and an optimistic upper bound that takes them all 1.
    """
    n = len(size)
    ranks = tuple(rank) if rank is not None else (None,) * n
    if len(ranks) != n:
        raise ValueError(f"{len(ranks)} ranks for {n} modes")
    upper = [r if r else u for r, u in zip(ranks, hosvd_rank_upper_bounds(size))]
    lower = [r if r else 1 for r in ranks]
    target_storage = prod(size) / com_ratio

    out = []
    for i in range(n):
        if ranks[i]:
            out.append((ranks[i], ranks[i]))
            continue
        storage_max_others = sum(upper[j] * size[j] for j in range(n) if j != i)
        prod_max_others = prod(upper[j] for j in range(n) if j != i)
        lo = max(1, int((target_storage - storage_max_others) / (size[i] + prod_max_others)))
        storage_min_others = sum(lower[j] * size[j] for j in range(n) if j != i)
        prod_min_others = prod(lower[j] for j in range(n) if j != i)
        hi = min(upper[i], int((target_storage - storage_min_others) / (size[i] + prod_min_others)))
        out.append((lo, hi))
    return out


def _unfold(tensor: torch.Tensor, mode: int, nbatch: int = 0) -> torch.Tensor:
    lead = tuple(range(nbatch))
    rest = tuple(d for d in range(nbatch, tensor.ndim) if d != mode + nbatch)
    x = tensor.permute(*lead, mode + nbatch, *rest)
    return x.reshape(*tensor.shape[:nbatch], tensor.shape[mode + nbatch], -1)


def unfold(tensor: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-`mode` unfolding: `(size[mode], prod(other sizes))`."""
    return _unfold(tensor, mode)


def _mode_product(tensor, matrix, mode: int, transpose: bool, nbatch: int = 0) -> torch.Tensor:
    x = torch.movedim(tensor, mode + nbatch, -1)
    m = matrix if transpose else matrix.transpose(-1, -2)  # (..., i, j)
    flat = x.reshape(*x.shape[:nbatch], -1, x.shape[-1])
    out = torch.matmul(flat, m).reshape(*x.shape[:-1], m.shape[-1])
    return torch.movedim(out, -1, mode + nbatch)


def mode_product(tensor: torch.Tensor, matrix: torch.Tensor, mode: int, transpose: bool = False) -> torch.Tensor:
    """n-mode product. `transpose=False` contracts the matrix's second index
    with the mode (the mode's size becomes the matrix's rows);
    `transpose=True` its first (the mode's size becomes its columns)."""
    return _mode_product(tensor, matrix, mode, transpose)


def _multi_mode_product(tensor, matrices, modes, transpose: bool, nbatch: int = 0) -> torch.Tensor:
    modes = list(range(len(matrices))) if modes is None else list(modes)
    out = tensor
    for matrix, mode in zip(matrices, modes):
        out = _mode_product(out, matrix, mode, transpose, nbatch)
    return out


def multi_mode_product(
    tensor: torch.Tensor,
    matrices: Sequence[torch.Tensor],
    modes: Optional[Sequence[int]] = None,
    transpose: bool = False,
) -> torch.Tensor:
    """`mode_product` with each matrix in turn (modes 0, 1, ... by default)."""
    return _multi_mode_product(tensor, matrices, modes, transpose)


def batched_multi_mode_product(
    tensor: torch.Tensor,
    matrices: Sequence[torch.Tensor],
    modes: Optional[Sequence[int]] = None,
    transpose: bool = False,
) -> torch.Tensor:
    """`multi_mode_product` over a leading batch dim of the tensor and of
    every matrix."""
    return _multi_mode_product(tensor, matrices, modes, transpose, nbatch=1)


def _hosvd(x: torch.Tensor, rank, nbatch: int = 0):
    nd = x.ndim - nbatch
    ranks = (rank,) * nd if rank is None or isinstance(rank, int) else tuple(rank)
    if len(ranks) != nd:
        raise ValueError(f"{len(ranks)} ranks for {nd} modes")
    factors = []
    for mode in range(nd):
        xm = _unfold(x, mode, nbatch)
        r = min(xm.shape[-2:]) if ranks[mode] is None else min(ranks[mode], *xm.shape[-2:])
        u, _, _ = truncated_svd(xm, r)
        factors.append(u)
    core = _multi_mode_product(x, factors, None, True, nbatch)
    return core, factors


def hosvd(x: torch.Tensor, rank=None):
    """HOSVD: `(core, factors)` with per-mode truncated left singular
    vectors. `rank`: None (full), an int for every mode, or one per mode."""
    return _hosvd(x, rank)


def batched_hosvd(x: torch.Tensor, rank=None):
    """`hosvd` of each entry of a leading batch dim, batched."""
    return _hosvd(x, rank, nbatch=1)
