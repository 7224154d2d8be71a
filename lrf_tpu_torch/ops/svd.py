"""Truncated SVD of tall-skinny patch matrices through the Gram matrix.

PyTorch port of `lrf_tpu/ops/svd.py`:

- `method="gram"` (default): form the Gram on the short side (N x N for an
  M x N patch stack), eigendecompose it with `torch.linalg.eigh` and recover
  the long-side factor with one product;
- `method="randomized"`: the randomized Gram range-finder of
  `randomized_truncated_svd` (the opt-in `init="fast"`), which replaces the
  N x N eigh with three K x K ones, K = rank + 10;
- `method="jacobi"`: the Gram path with the batched parallel Jacobi
  eigensolver of `lrf_tpu_torch.ops.jacobi` in place of
  `torch.linalg.eigh` (opt-in, as in the JAX package);
- `method="svd"`: `torch.linalg.svd`.

`shared_truncated_svd` takes the shared column-Gram eigh for every method,
as the JAX package does: there the method only picks the eigen-solver,
`torch.linalg.eigh` or, for "jacobi", `jacobi_eigh`.

Each method is split into a Gram half (`gram`, `top_pairs_from_gram`) and
a row-local half (`left_factor`), so a caller that holds X in row shards
can sum the shards' Grams and finish each shard on its own device.
"""

from __future__ import annotations

import numpy as np
import torch

from lrf_tpu_torch.ops.jacobi import jacobi_eigh

_METHODS = ("gram", "jacobi", "randomized", "svd")


def _check_method(method: str) -> None:
    if method not in _METHODS:
        raise ValueError(f"unknown SVD method {method!r}; one of {_METHODS}")


def _gram_eig(g: torch.Tensor, method: str):
    """Ascending eigendecomposition of a batched Gram: `torch.linalg.eigh`,
    or `jacobi_eigh` for "jacobi"."""
    return jacobi_eigh(g) if method == "jacobi" else torch.linalg.eigh(g)


def _tiny_root(dtype) -> float:
    return torch.finfo(dtype).tiny ** 0.5


def _top_from_eigh(evals, evecs, r: int):
    """`(s, v)`: the top `r` pairs of an ascending eigendecomposition of a
    column Gram, as singular values and right singular vectors."""
    evals = torch.flip(evals, dims=(-1,))[..., :r]
    v = torch.flip(evecs, dims=(-1,))[..., :, :r]
    return torch.sqrt(torch.clamp(evals, min=0.0)), v


def left_factor(x: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """`u = X v / s` (row-local: each row of X gives its row of u)."""
    return torch.matmul(x, v) / torch.clamp(s, min=_tiny_root(x.dtype))[..., None, :]


def gram(x: torch.Tensor) -> torch.Tensor:
    """Column Gram `X^T X` of `(..., M, N)`."""
    return torch.matmul(x.transpose(-1, -2), x)


def _randomized_from_gram(g: torch.Tensor, r: int, oversample: int = 10, seed: int = 0):
    """`(s, v)` of the top `r` pairs of a column Gram `g (..., N, N)` by the
    randomized range-finder (`lrf_tpu/ops/svd.py:150-209`).

    One seeded Gaussian sketch `(N, K)`, K = min(N, r + oversample), made by
    numpy exactly as the JAX package makes it, so both use the same sketch;
    two regularized-whitening passes (each a K x K eigh); a Rayleigh-Ritz
    K x K eigh. No power step: G is already X^T X, and one more power works
    with sigma^4, which collapses in float32.
    """
    n = g.shape[-1]
    k = min(n, r + oversample)
    omega = torch.from_numpy(np.random.default_rng(seed).standard_normal((n, k))).to(g.dtype).to(g.device)
    y = torch.matmul(g, omega)
    y = y / torch.clamp(torch.linalg.vector_norm(y, dim=-2, keepdim=True), min=1e-30)
    for _ in range(2):  # regularized whitening, twice
        se, sw = torch.linalg.eigh(torch.matmul(y.transpose(-1, -2), y))
        # a relative clamp, and an absolute floor for an all-zero stack (a
        # black channel), whose se is 0 everywhere: y is 0 there too, so any
        # finite inverse gives the right zero factors
        floor = torch.clamp(1e-6 * se[..., -1:], min=_tiny_root(g.dtype))
        y = torch.matmul(y, sw / torch.sqrt(torch.maximum(se, floor))[..., None, :])
    lam, w = torch.linalg.eigh(torch.matmul(torch.matmul(y.transpose(-1, -2), g), y))
    s, w = _top_from_eigh(lam, w, r)
    return s, torch.matmul(y, w)


def top_pairs_from_gram(g: torch.Tensor, r: int, method: str = "gram"):
    """`(s, v)`: top `r` singular values and right singular vectors of an X
    whose column Gram is `g`, by `method` ("gram", "jacobi" or "randomized")."""
    if method == "randomized":
        return _randomized_from_gram(g, r)
    if method not in ("gram", "jacobi"):
        raise ValueError(f"top_pairs_from_gram takes 'gram', 'jacobi' or 'randomized', not {method!r}")
    return _top_from_eigh(*_gram_eig(g, method), r)


def randomized_truncated_svd(x: torch.Tensor, rank: int, oversample: int = 10, seed: int = 0):
    """Top-`rank` triplets `(u, s, v)` of a tall `(..., M, N)` (M >= N) by
    the randomized Gram range-finder; deterministic and batch-invariant."""
    m, n = x.shape[-2], x.shape[-1]
    if n > m:
        raise ValueError("the randomized range-finder expects tall patch stacks (M >= N)")
    s, v = _randomized_from_gram(gram(x), min(rank, m, n), oversample, seed)
    return left_factor(x, s, v), s, v


def truncated_svd(x: torch.Tensor, rank: int, method: str = "gram"):
    """Top-`rank` singular triplets of `(..., M, N)`, descending order.

    Returns `(u, s, v)` with `u: (..., M, R)`, `s: (..., R)`, `v: (..., N, R)`
    (`v` holds right singular vectors as columns). `"randomized"` takes the
    exact Gram path for wide matrices, where the sketch saves nothing.
    """
    _check_method(method)
    m, n = x.shape[-2], x.shape[-1]
    r = min(rank, m, n)
    if method == "svd":
        u, s, vh = torch.linalg.svd(x, full_matrices=False)
        return u[..., :, :r], s[..., :r], vh.transpose(-1, -2)[..., :, :r]
    if n <= m:
        s, v = top_pairs_from_gram(gram(x), r, method)
        return left_factor(x, s, v), s, v
    # Gram on the short (row) side: G = X X^T, V = X^T U / s.
    s, u = _top_from_eigh(*_gram_eig(torch.matmul(x, x.transpose(-1, -2)), method), r)
    return u, s, left_factor(x.transpose(-1, -2), s, u)


def shared_truncated_svd(stacks, ranks, method: str = "gram"):
    """Truncated SVDs of several same-N patch stacks through ONE batched eigh.

    `stacks`: `(B_i, M_i, N)` tensors sharing N. Their column Grams are all
    `(N, N)`, so one `eigh` over the concatenated Gram batch serves every
    stack. Returns a list of `(u, s, v)` like `truncated_svd`. Every method
    takes this path, as in the JAX package, where the method picks only the
    solver of the shared eigh: `"jacobi"` takes `jacobi_eigh`, and `"svd"`
    and `"randomized"` give what `"gram"` gives.
    """
    _check_method(method)
    ranks = [min(r, x.shape[-2], x.shape[-1]) for x, r in zip(stacks, ranks)]
    pairs = shared_top_pairs([gram(x) for x in stacks], ranks, method)
    return [(left_factor(x, s, v), s, v) for x, (s, v) in zip(stacks, pairs)]


def shared_top_pairs(grams, ranks, method: str = "gram"):
    """The top `r` pairs `(s, v)` of several `(B_i, N, N)` Grams of one N,
    through one batched eigh (`jacobi_eigh` for "jacobi")."""
    n = grams[0].shape[-1]
    if any(g.shape[-1] != n for g in grams):
        raise ValueError("shared_truncated_svd needs stacks of one width N")
    flat = [g.reshape(-1, n, n) for g in grams]
    evals, evecs = _gram_eig(torch.cat(flat, dim=0), method)
    out = []
    offset = 0
    for g, f, r in zip(grams, flat, ranks):
        size = f.shape[0]
        ev = evals[offset : offset + size].reshape(g.shape[:-2] + (n,))
        evec = evecs[offset : offset + size].reshape(g.shape[:-2] + (n, n))
        out.append(_top_from_eigh(ev, evec, r))
        offset += size
    return out


def pad_rank(u: torch.Tensor, v: torch.Tensor, rank: int):
    """Zero-pad factors on the rank axis up to `rank`."""
    extra = rank - u.shape[-1]
    if extra > 0:
        u = torch.nn.functional.pad(u, (0, extra))
        v = torch.nn.functional.pad(v, (0, extra))
    return u, v


def svd_balanced_factors(x: torch.Tensor, rank: int, method: str = "gram"):
    """sqrt(s)-balanced truncated-SVD factors, `x ~ u @ v.T`.

    If `rank > min(M, N)` the factors are zero-padded on the rank axis.
    """
    r_eff = min(rank, x.shape[-2], x.shape[-1])
    u, s, v = truncated_svd(x, r_eff, method=method)
    rs = torch.sqrt(s)
    return pad_rank(u * rs[..., None, :], v * rs[..., None, :], rank)
