"""Tensor-Train decomposition.

PyTorch port of `lrf_tpu/ops/tt.py`: `ttd` (sequential reshaped truncated
SVDs, `torch.linalg.svd`), `contract_tt` (a chain of contractions), their
batched forms over a leading batch dim, and the TT rank-bound and
feasible-range helpers. Singular-vector signs are the solver's, so cores
may differ from the JAX package's by signs; contractions do not.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from lrf_tpu_torch.ops.common import prod

__all__ = [
    "ttd",
    "batched_ttd",
    "contract_tt",
    "batched_contract_tt",
    "tt_rank_upper_bounds",
    "tt_rank_feasible_ranges",
]


def tt_rank_upper_bounds(size: Sequence[int]) -> list[int]:
    """Rank bounds between consecutive modes."""
    return [min(prod(size[:i]), prod(size[i:])) for i in range(1, len(size))]


def tt_rank_feasible_ranges(size: Sequence[int], com_ratio: float):
    """Feasible TT-rank ranges for a target compression ratio."""
    upper = [1, *tt_rank_upper_bounds(size), 1]
    target_storage = prod(size) / com_ratio
    out = []
    for i in range(1, len(upper) - 1):
        storage_max_others = sum(
            upper[j] * size[j] * upper[j + 1] for j in range(len(size)) if j not in (i - 1, i)
        )
        lo = max(
            1,
            int((target_storage - storage_max_others) / (upper[i - 1] * size[i - 1] + upper[i + 1] * size[i])),
        )
        storage_min_others = sum(size[j - 1] for j in range(1, len(upper)) if j not in (i, i + 1))
        hi = min(upper[i], int((target_storage - storage_min_others) / (size[i - 1] + size[i])))
        out.append((lo, hi))
    return out


def _ttd(x: torch.Tensor, rank, nbatch: int = 0):
    shape = x.shape[nbatch:]
    lead = x.shape[:nbatch]
    nd = len(shape)
    ranks = [rank] * (nd - 1) if rank is None or isinstance(rank, int) else list(rank)
    if len(ranks) != nd - 1:
        raise ValueError(f"{len(ranks)} TT ranks for {nd} modes")
    ranks = [1, *(float("inf") if r is None else r for r in ranks), 1]

    unfolding = x
    factors: list = [None] * nd
    for k in range(nd - 1):
        unfolding = unfolding.reshape(*lead, int(ranks[k] * shape[k]), -1)
        m, n = unfolding.shape[-2:]
        r = int(min(m, n, ranks[k + 1]))
        u, s, vh = torch.linalg.svd(unfolding, full_matrices=False)
        ranks[k + 1] = r
        factors[k] = u[..., :r].reshape(*lead, int(ranks[k]), shape[k], r)
        unfolding = s[..., :r, None] * vh[..., :r, :]
    factors[-1] = unfolding
    factors[0] = factors[0][..., 0, :, :]  # drop the leading rank-1 dim
    return factors


def ttd(x: torch.Tensor, rank: Optional[Sequence[Optional[int]] | int] = None):
    """Tensor-Train decomposition: `x.ndim` factors, `(n0, r1)`, then
    `(r_k, n_k, r_{k+1})`, then `(r_{d-1}, n_{d-1})`."""
    return _ttd(x, rank)


def batched_ttd(x: torch.Tensor, rank=None):
    """`ttd` of each entry of a leading batch dim, batched."""
    return _ttd(x, rank, nbatch=1)


def _contract_tt(factors: Sequence[torch.Tensor], nbatch: int = 0) -> torch.Tensor:
    out = factors[0]
    for f in factors[1:]:
        lead = f.shape[:nbatch]
        r = f.shape[nbatch]
        flat = torch.matmul(out.reshape(*lead, -1, r), f.reshape(*lead, r, -1))
        out = flat.reshape(*out.shape[:-1], *f.shape[nbatch + 1:])
    return out


def contract_tt(factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The full tensor from its TT factors, by chain contraction."""
    return _contract_tt(factors)


def batched_contract_tt(factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """`contract_tt` over a leading batch dim of every factor."""
    return _contract_tt(factors, nbatch=1)
