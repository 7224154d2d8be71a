"""Quantization-aware matrix factorization (QMF) by block coordinate descent.

PyTorch port of `lrf_tpu/ops/bcd.py:42-325`: factor a patch-stack matrix
``X (M x N)`` as ``X ~ w0 + w1 * (U @ V^T)`` with integer-bounded factors.

- SVD initialization with sqrt(s)-balanced factors and the clip-minimising
  sign choice per rank component (`_finish_init`).
- Per-rank-column Gauss-Seidel sweeps. The exclusion
  ``U[:, !=r] @ B[!=r, r]`` is computed as ``U @ B[:, r] - U[:, r] * B[r, r]``.
- Integer projection: round half to even (`torch.round`, like `jnp.round`),
  then clamp to ``[ceil(lo), floor(hi)]``.

On CUDA tensors with ``factor=(0, 1)`` and no regularisation (the codec's
only mode), `bcd_from_init` runs the whole sweep loop in the hand-written
kernel of `lrf_tpu_torch.ops.bcd_kernel`. Every other mode, and every CPU
tensor, runs the plain sweeps below.

`sharded_svd_init` and `sharded_bcd` are the same init and plain sweeps on
an X held in row shards over several devices (a mesh's patch axis): the
sums over M are taken across shards in a fixed order.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from lrf_tpu_torch.ops.common import relative_error, safe_divide, soft_thresholding
from lrf_tpu_torch.ops.svd import (
    gram,
    gram64,
    gram_path,
    left_factor,
    pad_rank,
    rounded_sqrt,
    shared_svd_from_eigh,
    shared_top_pairs,
    shared_truncated_svd,
    svd_balanced_factors,
    top_pairs_from_gram,
)

_EPS = 1e-16


def make_project(bounds: tuple[Optional[float], Optional[float]]) -> Callable:
    """Integer projection: round half to even, then clamp to [ceil(lo), floor(hi)]."""
    lo, hi = bounds
    if lo is None and hi is None:
        return torch.round
    lo_i, hi_i = math.ceil(lo), math.floor(hi)

    def project(x):
        return torch.clamp(torch.round(x), lo_i, hi_i)

    return project


def svd_init(
    x: torch.Tensor,
    rank: int,
    num_levels: Optional[float] = None,
    method: str = "gram",
    bounds: tuple[Optional[float], Optional[float]] = (None, None),
):
    """QMF initializer: `(u, v, w)` with `w = [w0; w1]` stacked on dim -2.

    With `bounds`, each rank component's `(u_r, v_r)` pair takes the sign
    that clips less under the integer projection (see `lrf_tpu.ops.bcd.svd_init`).
    """
    u, v = svd_balanced_factors(x, rank, method=method)
    return _finish_init(x, u, v, num_levels, bounds)


def svd_init_shared(stacks, ranks, num_levels=None, bounds=(None, None), method="gram"):
    """`svd_init` for several same-N patch stacks sharing ONE batched eigh.

    Returns a list of `(u, v, w)` triples, each equal to that stack's own
    `svd_init`.
    """
    return _balanced_inits(stacks, ranks, shared_truncated_svd(stacks, ranks, method=method), num_levels, bounds)


def svd_init_from_eigh(stacks, ranks, evals, evecs, num_levels=None, bounds=(None, None)):
    """`svd_init_shared` from the ascending eigendecomposition of the
    stacks' `shared_gram`, taken by the caller: the encode pipeline fetches
    one batch's Grams while the host runs the previous batch's eigh."""
    return _balanced_inits(stacks, ranks, shared_svd_from_eigh(stacks, ranks, evals, evecs), num_levels, bounds)


def _balanced_inits(stacks, ranks, triplets, num_levels, bounds):
    out = []
    for x, rank, (u, s, v) in zip(stacks, ranks, triplets):
        rs = rounded_sqrt(s)
        u, v = pad_rank(u * rs[..., None, :], v * rs[..., None, :], rank)
        out.append(_finish_init(x, u, v, num_levels, bounds))
    return out


def clip_penalty(z: torch.Tensor, bounds) -> torch.Tensor:
    """Squared overshoot of `z` past the integer bounds, summed over dim -2,
    per rank component: `(..., 1, R)`."""
    lo_i, hi_i = math.ceil(bounds[0]), math.floor(bounds[1])
    over = torch.clamp(z - hi_i, min=0.0)
    under = torch.clamp(lo_i - z, min=0.0)
    return torch.sum(over * over + under * under, dim=-2, keepdim=True)


def _finish_init(x, u, v, num_levels, bounds):
    """Clip-minimising sign choice, optional num_levels rescale, affine `w`."""
    lo, hi = bounds
    if lo is not None and hi is not None:
        pen_pos = clip_penalty(u, bounds) + clip_penalty(v, bounds)
        pen_neg = clip_penalty(-u, bounds) + clip_penalty(-v, bounds)
        sign = torch.where(pen_neg < pen_pos, -1.0, 1.0).to(u.dtype)
        u = u * sign
        v = v * sign
    w0 = torch.zeros_like(x[..., 0:1, 0:1])
    w1 = torch.ones_like(w0)
    if num_levels:
        def span(z):
            return torch.amax(z, dim=(-2, -1), keepdim=True) - torch.amin(z, dim=(-2, -1), keepdim=True)

        scale_u = span(u) / num_levels
        scale_v = span(v) / num_levels
        u = u / scale_u
        v = v / scale_v
        w1 = (scale_u * scale_v) * w1
    return u, v, torch.cat([w0, w1], dim=-2)


def update_columns(a, b, u, l1: float, l2: float, project: Callable) -> torch.Tensor:
    """One Gauss-Seidel pass over all rank columns of `u`.

    `a = X @ V (..., M, R)`, `b = V^T V (..., R, R)`. Returns a new tensor;
    `u` is left unchanged.
    """
    u = u.clone()
    for r in range(u.shape[-1]):
        b_col = b[..., :, r : r + 1]
        b_rr = b[..., r : r + 1, r : r + 1]
        u_r = u[..., r : r + 1]
        term2 = torch.matmul(u, b_col) - u_r * b_rr
        numerator = soft_thresholding(a[..., r : r + 1] - term2, l1)
        u[..., r : r + 1] = project((numerator + _EPS) / (b_rr + l2 + _EPS))
    return u


def update_w(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Affine refit `x ~ w0 + w1 * (u v^T)` by the 2x2 normal equations."""
    z = torch.matmul(u, v.transpose(-1, -2)).reshape(*u.shape[:-2], -1)
    y = x.reshape(*x.shape[:-2], -1)
    n = z.shape[-1]
    sz = torch.sum(z, dim=-1)
    szz = torch.sum(z * z, dim=-1)
    sy = torch.sum(y, dim=-1)
    szy = torch.sum(z * y, dim=-1)
    det = n * szz - sz * sz
    det = torch.where(torch.abs(det) < _EPS, torch.full_like(det, _EPS), det)
    w0 = (szz * sy - sz * szy) / det
    w1 = (n * szy - sz * sy) / det
    return torch.stack([w0, w1], dim=-1)[..., None]


def bcd_sweep(
    x, u, v, w,
    factor: tuple[int, ...] = (0, 1, 2),
    project: Callable = torch.round,
    l2: tuple[float, float] = (0.0, 0.0),
    l1_ratio: float = 0.0,
):
    """One full coordinate-descent sweep; `factor` picks the blocks: 0 u, 1 v, 2 w."""
    m, n = x.shape[-2], x.shape[-1]
    l1_u = l2[0] * l1_ratio * n
    l1_v = l2[1] * l1_ratio * m
    l2_u = l2[0] * (1 - l1_ratio) * n
    l2_v = l2[1] * (1 - l1_ratio) * m
    w0 = w[..., 0:1, :]
    w1 = w[..., 1:2, :]
    if 0 in factor:
        xw = safe_divide(x - w0, w1, _EPS)
        a = torch.matmul(xw, v)
        b = torch.matmul(v.transpose(-1, -2), v)
        u = update_columns(a, b, u, l1_u, l2_u, project)
    if 1 in factor:
        xw = safe_divide(x.transpose(-1, -2) - w0, w1, _EPS)
        a = torch.matmul(xw, u)
        b = torch.matmul(u.transpose(-1, -2), u)
        v = update_columns(a, b, v, l1_v, l2_v, project)
    if 2 in factor:
        w = update_w(x, u, v)
    return u, v, w


def qmf_decompose(
    x: torch.Tensor,
    rank: int,
    num_iters: int = 10,
    bounds: tuple[Optional[float], Optional[float]] = (None, None),
    factor: tuple[int, ...] = (0, 1),
    l2: tuple[float, float] = (0.0, 0.0),
    l1_ratio: float = 0.0,
    num_levels: Optional[float] = None,
    init_method: str = "gram",
):
    """Full QMF decomposition: `x (..., M, N)` -> integer-valued float
    `u (..., M, R)`, `v (..., N, R)` and affine `w (..., 2, 1)`."""
    x = x.to(torch.float32)
    init = svd_init(x, rank, num_levels=num_levels, method=init_method, bounds=bounds)
    return bcd_from_init(
        x, init, num_iters=num_iters, bounds=bounds, factor=factor, l2=l2, l1_ratio=l1_ratio
    )


def bcd_from_init(
    x: torch.Tensor,
    init,
    num_iters: int = 10,
    bounds: tuple[Optional[float], Optional[float]] = (None, None),
    factor: tuple[int, ...] = (0, 1),
    l2: tuple[float, float] = (0.0, 0.0),
    l1_ratio: float = 0.0,
):
    """The BCD sweep loop of `qmf_decompose` from a precomputed `(u, v, w)`."""
    x = x.to(torch.float32)
    u, v, w = init
    if x.is_cuda and tuple(factor) == (0, 1) and tuple(l2) == (0.0, 0.0):
        from lrf_tpu_torch.ops.bcd_kernel import bcd

        # w stays fixed under factor=(0, 1), so both sweeps see the same
        # affinely normalised X; the kernel runs on it directly.
        xw = safe_divide(x - w[..., 0:1, :], w[..., 1:2, :], _EPS)
        lead = x.shape[:-2]
        u, v = bcd(
            xw.reshape(-1, *x.shape[-2:]).contiguous(),
            u.reshape(-1, *u.shape[-2:]),
            v.reshape(-1, *v.shape[-2:]),
            num_iters=num_iters,
            bounds=bounds,
        )
        return u.reshape(*lead, *u.shape[-2:]), v.reshape(*lead, *v.shape[-2:]), w
    project = make_project(bounds)
    for _ in range(num_iters):
        u, v, w = bcd_sweep(x, u, v, w, factor=factor, project=project, l2=l2, l1_ratio=l1_ratio)
    return u, v, w


def sum_shards(parts, device: torch.device) -> torch.Tensor:
    """Sum of per-shard partials, added in shard order on `device`: the
    fixed-order counterpart of a psum, so the result never depends on
    which shard finished first."""
    total = parts[0].to(device, non_blocking=True)
    for part in parts[1:]:
        total = total + part.to(device, non_blocking=True)
    return total


def sharded_svd_init(stacks, ranks, bounds, method: str = "gram"):
    """The codec's init (`svd_init_shared`, or `svd_init(method=
    "randomized")` per stack) for stacks held in row shards.

    `stacks[i]` lists the `(B, M_p, N)` row shards of stack i, one per
    device, in row order. Each shard's column Gram and clip penalties are
    summed on the first shard's device, v is computed there, and u stays
    sharded (`u = X v / s` is row-local). `"gram"` takes one batched eigh
    over every stack's Gram; otherwise `gram_path` picks each stack's path,
    as for `truncated_svd`. An exact Gram sums the shards' float64 Grams
    (`gram64`) and rounds once, so its init equals the unsharded one's.
    Returns per stack `(u_shards, v)`.
    """
    home = stacks[0][0].device
    shapes = [(sum(x.shape[-2] for x in shards), shards[0].shape[-1]) for shards in stacks]
    paths = [gram_path(method, m, n) for m, n in shapes]
    grams = [sum_shards([gram64(x) for x in shards], home).to(shards[0].dtype) if exact
             else sum_shards([gram(x) for x in shards], home) for shards, (_, exact) in zip(stacks, paths)]
    r_effs = [min(r, m, n) for r, (m, n) in zip(ranks, shapes)]
    if method == "gram":
        pairs = shared_top_pairs(grams, r_effs)
    else:
        pairs = [top_pairs_from_gram(g, r, solver) for g, r, (solver, _) in zip(grams, r_effs, paths)]
    out = []
    for shards, rank, (_, exact), (s, v) in zip(stacks, ranks, paths, pairs):
        rs = rounded_sqrt(s)[..., None, :]
        us = [left_factor(x, s.to(x.device, non_blocking=True), v.to(x.device, non_blocking=True), exact)
              * rs.to(x.device, non_blocking=True) for x in shards]
        us = [torch.nn.functional.pad(u, (0, rank - u.shape[-1])) for u in us]
        v = torch.nn.functional.pad(v * rs, (0, rank - v.shape[-1]))
        if bounds[0] is not None and bounds[1] is not None:
            pen_pos = sum_shards([clip_penalty(u, bounds) for u in us], home) + clip_penalty(v, bounds)
            pen_neg = sum_shards([clip_penalty(-u, bounds) for u in us], home) + clip_penalty(-v, bounds)
            sign = torch.where(pen_neg < pen_pos, -1.0, 1.0).to(v.dtype)
            us = [u * sign.to(u.device, non_blocking=True) for u in us]
            v = v * sign
        out.append((us, v))
    return out


def sharded_bcd(shards, us, v, num_iters: int = 10, bounds=(-16, 15)):
    """`bcd_reference` on X held in row shards (`shards[p]`: `(B, M_p, N)`,
    `us[p]`: `(B, M_p, R)`, each on its own device; `v` on the first).

    The U update is row-local, from X_p V and VᵀV on each shard's device.
    The V update needs XᵀU and UᵀU over all rows: their shard partials are
    summed in shard order on v's device (`sum_shards`), and the new v is
    copied back to every shard for the next sweep.
    """
    project = make_project(bounds)
    home = v.device
    for _ in range(num_iters):
        vs = [v.to(x.device, non_blocking=True) for x in shards]
        us = [update_columns(torch.matmul(x, vd), torch.matmul(vd.transpose(-1, -2), vd), u, 0.0, 0.0, project)
              for x, u, vd in zip(shards, us, vs)]
        a = sum_shards([torch.matmul(x.transpose(-1, -2), u) for x, u in zip(shards, us)], home)
        b = sum_shards([torch.matmul(u.transpose(-1, -2), u) for u in us], home)
        v = update_columns(a, b, v, 0.0, 0.0, project)
    return us, v


def qmf_reconstruct(u: torch.Tensor, v: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`u @ v^T`, optionally affine-shifted."""
    out = torch.matmul(u.to(torch.float32), v.to(torch.float32).transpose(-1, -2))
    if w is None:
        return out
    return w[..., 0:1, :] + w[..., 1:2, :] * out


def qmf_loss(x, u, v, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Relative reconstruction error."""
    return relative_error(x, qmf_reconstruct(u, v, w))
