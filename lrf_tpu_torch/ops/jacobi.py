"""Batched symmetric eigendecomposition by parallel cyclic Jacobi.

PyTorch port of `lrf_tpu/ops/jacobi.py`: the round-robin ("circle
method") schedule, in which each of the `N - 1` rounds of a sweep rotates
`N / 2` disjoint pivot pairs at once. A round is one batched orthogonal
update `G <- R^T G R`, `V <- V R`: R is built by one scatter of the
rotations' (c, s) into a zero matrix (the pairs cover every index, so
every diagonal entry is set), and applied by batched products. The
schedule does not depend on the data, so an image's result does not
depend on its batch.

It is the opt-in `method="jacobi"` of `lrf_tpu_torch.ops.svd`, as in the
JAX package, where it was measured and not adopted: its float32 trailing
eigenvectors cost PSNR at higher ranks (`lrf_tpu/ops/jacobi.py:9-16`).
On the card each round is a handful of small torch launches driven from
the host.

Returns ascending eigenvalues, like `torch.linalg.eigh`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["jacobi_eigh"]


def _round_robin_pairs(n: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """The circle-method schedule: n - 1 rounds of n / 2 disjoint (p, q)
    pairs, p < q, covering every unordered pair once per sweep."""
    if n % 2:
        raise ValueError(f"the round-robin schedule needs an even N, got {n}")
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        ps, qs = [], []
        for i in range(n // 2):
            a, b = players[i], players[n - 1 - i]
            ps.append(min(a, b))
            qs.append(max(a, b))
        rounds.append((np.asarray(ps), np.asarray(qs)))
        players = [players[0]] + [players[-1]] + players[1:-1]  # rotate all but the first
    return rounds


def _round_indices(n: int, device: torch.device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per round, on `device`: the flat indices of (p, p), (q, q) and (p, q)
    in an n x n matrix, `(3 n/2,)`, and those of (p, p), (q, q), (p, q),
    (q, p), where R takes c, c, s, -s, `(2 n,)`."""
    out = []
    for ps, qs in _round_robin_pairs(n):
        pp, qq, pq, qp = ps * n + ps, qs * n + qs, ps * n + qs, qs * n + ps
        out.append((torch.from_numpy(np.concatenate([pp, qq, pq])).to(device),
                    torch.from_numpy(np.concatenate([pp, qq, pq, qp])).to(device)))
    return out


def jacobi_eigh(g: torch.Tensor, sweeps: int = 10):
    """Eigendecomposition `(evals, evecs)` of symmetric `(..., N, N)`, N even,
    ascending, in float32: a drop-in for `torch.linalg.eigh` on small
    batched matrices."""
    n = g.shape[-1]
    batch_shape = g.shape[:-2]
    g = g.reshape(-1, n, n).to(torch.float32)
    b, half = g.shape[0], n // 2
    rounds = _round_indices(n, g.device)
    v = torch.eye(n, dtype=torch.float32, device=g.device).expand(b, n, n)
    for _ in range(sweeps):
        for gather, scatter in rounds:
            app, aqq, apq = g.reshape(b, n * n)[:, gather].split(half, dim=1)
            # the classic stable rotation, t = sign(tau) / (|tau| + sqrt(1 + tau^2))
            small = torch.abs(apq) <= 1e-30 * torch.clamp(torch.abs(app) + torch.abs(aqq), min=1e-30)
            tau = (aqq - app) / torch.where(small, torch.ones_like(apq), 2.0 * apq)
            # sign(0) := +1: a zero sign would leave an equal-diagonal pair
            # (app == aqq) unrotated, where it needs the full 45 degrees
            sgn = torch.where(tau >= 0, 1.0, -1.0)
            t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(small, torch.zeros_like(t), t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            r = torch.zeros(b, n * n, dtype=torch.float32, device=g.device)
            r = r.scatter(1, scatter.expand(b, -1), torch.cat([c, c, s, -s], dim=1)).reshape(b, n, n)
            g = torch.matmul(torch.matmul(r.transpose(-1, -2), g), r)
            g = 0.5 * (g + g.transpose(-1, -2))  # exact symmetry
            v = torch.matmul(v, r)
    evals = torch.diagonal(g, dim1=-2, dim2=-1)
    order = torch.argsort(evals, dim=-1, stable=True)
    evals = torch.take_along_dim(evals, order, dim=-1)
    v = torch.take_along_dim(v, order[:, None, :], dim=-1)
    return evals.reshape(*batch_shape, n), v.reshape(*batch_shape, n, n)
