"""Truncated SVD of tall-skinny patch matrices through the Gram matrix.

PyTorch port of the Gram/eigh path of `lrf_tpu/ops/svd.py:26-147`: form the
Gram on the short side (N x N for an M x N patch stack), eigendecompose it
with `torch.linalg.eigh` and recover the long-side factor with one product.
`method="svd"` takes `torch.linalg.svd` instead. The randomized range-finder
and the Jacobi eigensolver are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

_NOT_PORTED = {
    "randomized": "the randomized range-finder init (ROADMAP queue 1, item 9)",
    "jacobi": "the batched Jacobi eigensolver (ROADMAP queue 1, item 11)",
}


def _check_method(method: str) -> None:
    if method in _NOT_PORTED:
        raise NotImplementedError(f"method={method!r} is {_NOT_PORTED[method]}, not ported yet")
    if method not in ("gram", "svd"):
        raise ValueError(f"unknown SVD method {method!r}")


def _tiny_root(dtype) -> float:
    return torch.finfo(dtype).tiny ** 0.5


def _factors_from_gram_eigh(x, evals, evecs, r: int):
    """Truncated `(u, s, v)` of `x` from the ascending eigh of `X^T X`."""
    evals = torch.flip(evals, dims=(-1,))[..., :r]
    v = torch.flip(evecs, dims=(-1,))[..., :, :r]
    s = torch.sqrt(torch.clamp(evals, min=0.0))
    safe = torch.clamp(s, min=_tiny_root(x.dtype))
    u = torch.matmul(x, v) / safe[..., None, :]
    return u, s, v


def _gram(x: torch.Tensor) -> torch.Tensor:
    """Column Gram `X^T X` of `(..., M, N)`."""
    return torch.matmul(x.transpose(-1, -2), x)


def truncated_svd(x: torch.Tensor, rank: int, method: str = "gram"):
    """Top-`rank` singular triplets of `(..., M, N)`, descending order.

    Returns `(u, s, v)` with `u: (..., M, R)`, `s: (..., R)`, `v: (..., N, R)`
    (`v` holds right singular vectors as columns).
    """
    _check_method(method)
    m, n = x.shape[-2], x.shape[-1]
    r = min(rank, m, n)
    if method == "svd":
        u, s, vh = torch.linalg.svd(x, full_matrices=False)
        return u[..., :, :r], s[..., :r], vh.transpose(-1, -2)[..., :, :r]
    if n <= m:
        evals, evecs = torch.linalg.eigh(_gram(x))
        return _factors_from_gram_eigh(x, evals, evecs, r)
    # Gram on the short (row) side: G = X X^T, V = X^T U / s.
    evals, evecs = torch.linalg.eigh(torch.matmul(x, x.transpose(-1, -2)))
    evals = torch.flip(evals, dims=(-1,))[..., :r]
    u = torch.flip(evecs, dims=(-1,))[..., :, :r]
    s = torch.sqrt(torch.clamp(evals, min=0.0))
    safe = torch.clamp(s, min=_tiny_root(x.dtype))
    v = torch.matmul(x.transpose(-1, -2), u) / safe[..., None, :]
    return u, s, v


def shared_truncated_svd(stacks, ranks, method: str = "gram"):
    """Truncated SVDs of several same-N patch stacks through ONE batched eigh.

    `stacks`: `(B_i, M_i, N)` tensors sharing N. Their column Grams are all
    `(N, N)`, so one `eigh` over the concatenated Gram batch serves every
    stack. Returns a list of `(u, s, v)` like `truncated_svd`.
    """
    _check_method(method)
    if method != "gram":
        return [truncated_svd(x, r, method) for x, r in zip(stacks, ranks)]
    n = stacks[0].shape[-1]
    if any(x.shape[-1] != n for x in stacks):
        raise ValueError("shared_truncated_svd needs stacks of one width N")
    grams = [_gram(x).reshape(-1, n, n) for x in stacks]
    sizes = [g.shape[0] for g in grams]
    evals, evecs = torch.linalg.eigh(torch.cat(grams, dim=0))
    out = []
    offset = 0
    for x, rank, size in zip(stacks, ranks, sizes):
        r = min(rank, x.shape[-2], n)
        ev = evals[offset : offset + size].reshape(x.shape[:-2] + (n,))
        evec = evecs[offset : offset + size].reshape(x.shape[:-2] + (n, n))
        out.append(_factors_from_gram_eigh(x, ev, evec, r))
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
