"""Class-based factorization API: `RandInit`, `SVDInit`, `CoordinateDescent`,
`QMF` and `HOSVD` as `nn.Module`s.

PyTorch port of `lrf_tpu/ops/modules.py`, with the same constructor
parameters and `decompose` / `reconstruct` / `forward` contracts. The
modules hold no parameters: each wraps the functional ops of
`lrf_tpu_torch.ops`.

`QMF.decompose` runs the init and then `lrf_tpu_torch.ops.bcd.bcd_from_init`,
so on a CUDA tensor in the codec's mode (`factor=(0, 1)`, no
regularisation) its sweeps run in the BCD kernel, exactly as the functional
`qmf_decompose` runs them, and the two give the same factors. With
`verbose=True` it calls `bcd_from_init` once per sweep: one kernel launch
per sweep, the same factors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from lrf_tpu_torch.ops.bcd import (
    bcd_from_init,
    bcd_sweep,
    make_project,
    qmf_loss,
    qmf_reconstruct,
    svd_init,
    update_w,
)
# `lrf_tpu_torch.ops.hosvd` is the function in the package namespace (as in
# the JAX package), so take the functions from their module directly.
from lrf_tpu_torch.ops.hosvd import hosvd as _hosvd_fn
from lrf_tpu_torch.ops.hosvd import multi_mode_product as _multi_mode_product

__all__ = ["RandInit", "SVDInit", "CoordinateDescent", "QMF", "HOSVD"]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class RandInit(nn.Module):
    """Uniform integer init in `bounds`: returns `(u, v)` only, as the
    reference's does.

    The draws come from a `torch.Generator` seeded with `seed` on the
    input's device: the same seed gives the same factors on one device,
    but not the JAX package's (another generator)."""

    def __init__(self, rank: int, bounds: tuple[float, float], seed: int = 0) -> None:
        super().__init__()
        self.rank = rank
        self.bounds = bounds
        self.seed = seed

    def forward(self, x: torch.Tensor):
        m, n = x.shape[-2], x.shape[-1]
        lo, hi = int(self.bounds[0]), int(self.bounds[1]) + 1
        gen = torch.Generator(device=x.device).manual_seed(self.seed)
        u = torch.randint(lo, hi, (*x.shape[:-2], m, self.rank), generator=gen, device=x.device)
        v = torch.randint(lo, hi, (*x.shape[:-2], n, self.rank), generator=gen, device=x.device)
        return u.to(torch.float32), v.to(torch.float32)


class SVDInit(nn.Module):
    """sqrt(s)-balanced truncated-SVD init, `(u, v, w)`; with `bounds`, each
    component takes the sign that clips less (see `ops.bcd.svd_init`)."""

    def __init__(
        self,
        rank: int,
        num_levels: Optional[float] = None,
        method: str = "gram",
        bounds: tuple = (None, None),
    ) -> None:
        super().__init__()
        self.rank = rank
        self.num_levels = num_levels
        self.method = method
        self.bounds = bounds

    def forward(self, x: torch.Tensor):
        return svd_init(x, self.rank, num_levels=self.num_levels, method=self.method, bounds=self.bounds)


class CoordinateDescent(nn.Module):
    """One block coordinate descent sweep.

    `factor` picks the blocks (0 u, 1 v, 2 w); `project` runs after each
    column update; `l2` and `l1_ratio` give elastic-net regularisation,
    scaled by the opposite dimension as in the reference.
    """

    def __init__(
        self,
        factor=(0, 1, 2),
        project: Optional[Callable] = None,
        l2=0.0,
        l1_ratio: float = 0.0,
    ) -> None:
        super().__init__()
        self.factor = (factor,) if isinstance(factor, int) else tuple(factor)
        self.project = project if project is not None else (lambda x: x)
        self.l2 = _pair(l2)
        self.l1_ratio = l1_ratio

    def forward(self, x, factors):
        u, v, w = factors
        return bcd_sweep(x, u, v, w, factor=self.factor, project=self.project, l2=self.l2, l1_ratio=self.l1_ratio)

    update_w = staticmethod(update_w)


class QMF(nn.Module):
    """Quantization-aware matrix factorization, ``X ~ w0 + w1 * (U @ V^T)``
    with integer-bounded U, V, on `(..., M, N)` batches.

    `decompose` runs the SVD init and `num_iters` coordinate-descent sweeps
    through `bcd_from_init` (in the BCD kernel on CUDA tensors in the codec's
    mode); with `verbose=True` it runs them one call at a time and prints
    the loss before each. `reconstruct` and `loss` are static.
    """

    def __init__(
        self,
        rank: Optional[int],
        num_iters: int = 10,
        bounds=(None, None),
        num_levels: Optional[float] = None,
        factor=(0, 1),
        l2=0.0,
        l1_ratio: float = 0.0,
        init_method: str = "gram",
        verbose: bool = False,
    ) -> None:
        super().__init__()
        self.rank = rank
        self.num_iters = num_iters
        self.bounds = tuple(bounds)
        # the bounds reach the init too, so its sign choice is the one the
        # functional `qmf_decompose` makes
        self.init = SVDInit(rank=rank, num_levels=num_levels, method=init_method, bounds=self.bounds)
        self.solver = CoordinateDescent(factor=factor, project=make_project(self.bounds), l2=l2, l1_ratio=l1_ratio)
        self.verbose = verbose

    def decompose(self, x: torch.Tensor):
        x = torch.as_tensor(x).to(torch.float32)
        factors = self.init(x)
        solver = self.solver
        # one call for all sweeps, or one per sweep with the loss printed first
        for it, sweeps in enumerate([1] * self.num_iters if self.verbose else [self.num_iters], start=1):
            if self.verbose:
                print(f"iter {it}: loss = {qmf_loss(x, *factors)}")
            factors = bcd_from_init(x, factors, num_iters=sweeps, bounds=self.bounds,
                                    factor=solver.factor, l2=solver.l2, l1_ratio=solver.l1_ratio)
        return factors

    reconstruct = staticmethod(qmf_reconstruct)
    loss = staticmethod(qmf_loss)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reconstruct(*self.decompose(x))


class HOSVD(nn.Module):
    """Tucker / HOSVD: `decompose` gives `(core, factors)`, `reconstruct`
    their multi-mode product; `forward` round-trips."""

    def __init__(self, rank=None) -> None:
        super().__init__()
        self.rank = rank

    def decompose(self, x: torch.Tensor):
        return _hosvd_fn(x, rank=self.rank)

    @staticmethod
    def reconstruct(core, factors):
        return _multi_mode_product(core, factors, transpose=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reconstruct(*self.decompose(x))
