"""Truncated SVD of tall-skinny patch matrices through the Gram matrix.

PyTorch port of `lrf_tpu/ops/svd.py`:

- `method="gram"` (default): form the Gram on the short side (N x N for an
  M x N patch stack), eigendecompose it and recover the long-side factor
  with one product;
- `method="randomized"`: the randomized Gram range-finder of
  `randomized_truncated_svd` (the opt-in `init="fast"`), which replaces the
  N x N eigh with three K x K ones (`torch.linalg.eigh`), K = rank + 10;
- `method="jacobi"`: the Gram path with the batched parallel Jacobi
  eigensolver of `lrf_tpu_torch.ops.jacobi` (opt-in, as in the JAX
  package);
- `method="svd"`: `torch.linalg.svd`.

`shared_truncated_svd` takes the shared column-Gram eigh for every method,
as the JAX package does: there the method only picks the eigen-solver.

The exact Gram path (the QMF init: `shared_truncated_svd`, `truncated_svd`'s
"gram", and "randomized" on wide stacks; `gram_path` decides) is made to
give one result on every device:

- its Gram, `exact_gram`, is `X^T X` formed from float64 copies and
  rounded to float32 once, and its long-side product, `left_factor`, is
  `X v` formed the same way before the division by s. Both are then
  correctly rounded (but for ties a float64 sum almost never reaches),
  whatever BLAS, device or row sharding summed them;
- its eigensolver, `_lapack_eigh`, is LAPACK's `?syevd` on the host, the
  JAX package's CPU `eigh`, on every device: the routine that
  `scipy.linalg.cython_lapack` exports and jaxlib calls, run over the
  whole batch in one native call (`native/lapack_batch.py`) that releases
  the GIL and splits the small Grams over the host's cores, each worker on
  an OpenBLAS instance of its own;
- its square roots (`rounded_sqrt`) and `left_factor`'s division are taken
  in float64 and rounded once, so they are correctly rounded on every
  device: torch's float32 `sqrt` on the CPU is not always, the card's is,
  and that alone parted the card's init from the CPU's.

So the card's init is the CPU's, bit for bit.

The HOSVD codecs' mode SVDs (`ops/hosvd.py`) take `_lapack_eigh` too, for
the JAX package's eigenvector signs, but keep float32 Grams and products:
a float64 mode Gram moved one local7 photograph 2.5 dB off the JAX
package. `_lapack_svd` is the SVD codec's factorization (`models/svd.py`):
LAPACK's `?gesdd`, the JAX package's CPU `svd`, on the host. The
randomized range finder keeps the float32 `gram`, which its test holds
against the JAX package's float32 sketch.

Each method is split into a Gram half (`gram64`, `top_pairs_from_gram`) and
a row-local half (`left_factor`), so a caller that holds X in row shards
can sum the shards' Grams and finish each shard on its own device.
"""

from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import scipy.linalg
import torch

from lrf_tpu_torch.native import lapack_batch
from lrf_tpu_torch.native.lapack_batch import openblas_threads as _openblas_threads
from lrf_tpu_torch.ops.jacobi import jacobi_eigh
from lrf_tpu_torch.utils import profiling

_METHODS = ("gram", "jacobi", "randomized", "svd")


def _check_method(method: str) -> None:
    if method not in _METHODS:
        raise ValueError(f"unknown SVD method {method!r}; one of {_METHODS}")


def _gram_eig(g: torch.Tensor, method: str):
    """Ascending eigendecomposition of a batched Gram on the exact path:
    `_lapack_eigh` on every device, or `jacobi_eigh` for "jacobi"."""
    return jacobi_eigh(g) if method == "jacobi" else _lapack_eigh(g)


# Grams up to this order are eigendecomposed on one BLAS thread each, with
# the batch split over the host's cores: the init's 64 x 64 gain nothing
# from OpenBLAS's threads, while the HOSVD codecs' 512 and 768 mode Grams
# run about twice as fast on eight.
_ONE_THREAD_MAX_N = 128


class _BlasGate:
    """Who runs host LAPACK, and on how many OpenBLAS threads.

    OpenBLAS's thread count is process-wide, so the gate has two modes.
    `one_thread()` holders (the eigh of Grams up to `_ONE_THREAD_MAX_N`)
    share it: the first one in sets the count to 1, and the last one out
    restores the count it found, so a data mesh's rows run their init
    eighs side by side. A `many_threads()` holder (`_lapack_svd`, the eigh
    of larger Grams) holds it alone, on the count the process had. Once a
    many-thread holder waits, new one-thread holders wait behind it, so it
    is not starved. `mode` is "one_thread", "many_threads" or None.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._sharers = 0
        self._alone = False
        self._waiting = 0
        self._found = None

    @property
    def mode(self):
        with self._cond:
            return "many_threads" if self._alone else ("one_thread" if self._sharers else None)

    @contextlib.contextmanager
    def one_thread(self):
        get, set_ = _openblas_threads()
        with self._cond:
            self._cond.wait_for(lambda: not self._alone and not self._waiting)
            if not self._sharers:
                self._found = get()
                set_(1)
            self._sharers += 1
        try:
            yield
        finally:
            with self._cond:
                self._sharers -= 1
                if not self._sharers:
                    set_(self._found)
                    self._cond.notify_all()

    @contextlib.contextmanager
    def many_threads(self):
        with self._cond:
            self._waiting += 1
            try:
                self._cond.wait_for(lambda: not self._alone and not self._sharers)
            finally:
                self._waiting -= 1
                self._cond.notify_all()
            self._alone = True
        try:
            yield
        finally:
            with self._cond:
                self._alone = False
                self._cond.notify_all()


_GATE = _BlasGate()


def _host_lapack(one_thread: bool):
    """The gate for one host LAPACK loop: shared on one OpenBLAS thread
    (`one_thread`), or alone on the process's count.

    On a many-core host OpenBLAS splits each small `?syevd` over all cores
    for no gain in wall time, and its threads then spin after every call,
    taking the cores from the native serializer that follows the init; on
    one thread each, the small Grams' batch is split over the cores by the
    native batch instead (its private copies of the OpenBLAS are always on
    one thread). On the CPU tests' host the bits of Grams up to 192 x 192
    did not depend on OpenBLAS's thread count, but those of 256 x 256 and
    larger did (1 thread against 2 or 8), so a large Gram must never run on
    a count that another thread set to 1: hence the mode that holds the
    gate alone. Where scipy links no OpenBLAS of its own, whose count this
    module cannot set, every loop holds the gate alone."""
    if one_thread and _openblas_threads() is not None:
        return _GATE.one_thread()
    return _GATE.many_threads()


def _lapack_eigh(g: torch.Tensor):
    """Ascending eigendecomposition of a batched Gram by LAPACK's `?syevd`
    on the host in the Gram's dtype (float32 or float64), in one native call
    for the whole batch (`native/lapack_batch.py::syevd_batch`); the result
    goes back to the Gram's device.

    Grams up to `_ONE_THREAD_MAX_N` share the gate on one OpenBLAS thread,
    split over one worker per LAPACK instance (`lapack_batch.instances()`:
    scipy's OpenBLAS and private copies of it, up to one per available
    CPU; at most one worker per matrix); larger ones hold the gate alone
    and run one after another on scipy's OpenBLAS and its own threads, as
    do all where scipy links no OpenBLAS of its own. The call releases the
    GIL, so the eighs of several host threads (a data mesh's rows) overlap,
    their workers sharing the instances. The bits do not depend on the
    worker count and equal `_lapack_eigh_plain`'s.

    The JAX package's CPU `eigh` is this LAPACK routine, so the eigenvector
    signs are the JAX package's wherever the two Grams' last bits do not
    flip LAPACK's choice. `torch.linalg.eigh` takes another LAPACK's (or
    cuSOLVER's) signs, and the HOSVD codecs' truncating quantizers turn
    signs into PSNR: up to 2 dB apart on photographs at bpp 0.5.
    """
    with profiling.span("lrf.encode.init.gram_fetch", bytes_in=g.nbytes):
        host = g.detach().cpu().numpy()
    evals, evecs = _syevd(host)
    return torch.from_numpy(evals).to(g.device), torch.from_numpy(evecs).to(g.device)


def _syevd(host: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """`_lapack_eigh`'s host part: the native batch under the gate and the
    `lrf.encode.init.eigh` span."""
    one = host.shape[-1] <= _ONE_THREAD_MAX_N and _openblas_threads() is not None
    with _host_lapack(one), profiling.span("lrf.encode.init.eigh", bytes_in=host.nbytes, mirror=True):
        return lapack_batch.syevd_batch(host, 0 if one else 1)


def host_eigh(host: np.ndarray, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """`_lapack_eigh` of Grams the caller has already fetched to the host
    (the encode pipeline, which starts their copy a batch ahead): the same
    `?syevd` batch, its results sent to `device`. On a card they leave from
    page-locked copies with `non_blocking`, so, unlike a pageable
    `.to(device)`, the call does not wait for the work queued on the
    stream."""
    out = tuple(torch.from_numpy(a) for a in _syevd(host))
    if device.type != "cuda":
        return out
    return tuple(t.pin_memory().to(device, non_blocking=True) for t in out)


def _lapack_eigh_plain(g: torch.Tensor):
    """`_lapack_eigh`'s plain version: `scipy.linalg.eigh(driver="evd")`, one
    matrix at a time in a Python loop, under the same gate. scipy's wrapper
    holds the GIL through each call. Tests and the card's smoke test hold
    the native batch to it; nothing on the codec's path calls it."""
    host = g.detach().cpu().numpy()
    flat = host.reshape(-1, *host.shape[-2:])
    evals = np.empty(flat.shape[:-1], flat.dtype)
    evecs = np.empty_like(flat)
    with _host_lapack(flat.shape[-1] <= _ONE_THREAD_MAX_N):
        for i, a in enumerate(flat):
            evals[i], evecs[i] = scipy.linalg.eigh(a, driver="evd")
    return (torch.from_numpy(evals.reshape(host.shape[:-1])).to(g.device),
            torch.from_numpy(evecs.reshape(host.shape)).to(g.device))


def _lapack_svd(a: torch.Tensor):
    """Thin SVD `(u, s, vh)` of a batched `(..., M, N)` by LAPACK's `?gesdd`
    (`scipy.linalg.svd(lapack_driver="gesdd")`), one matrix at a time on
    the host in the input's dtype; the result goes back to the input's
    device.

    The JAX package's CPU `svd` is this LAPACK routine, so the singular
    vectors' signs are the JAX package's. `torch.linalg.svd` takes another
    LAPACK's (or cuSOLVER's) signs, and the SVD codec's truncating quantizer
    turns signs into PSNR.
    """
    host = a.detach().cpu().numpy()
    flat = host.reshape(-1, *host.shape[-2:])
    k = min(flat.shape[-2:])
    u = np.empty((flat.shape[0], flat.shape[1], k), flat.dtype)
    s = np.empty((flat.shape[0], k), flat.dtype)
    vh = np.empty((flat.shape[0], k, flat.shape[2]), flat.dtype)
    with _host_lapack(False):
        for i, m in enumerate(flat):
            u[i], s[i], vh[i] = scipy.linalg.svd(m, full_matrices=False, lapack_driver="gesdd")
    lead = host.shape[:-2]
    return tuple(torch.from_numpy(t.reshape(lead + t.shape[1:])).to(a.device) for t in (u, s, vh))


def _tiny_root(dtype) -> float:
    return torch.finfo(dtype).tiny ** 0.5


def rounded_sqrt(x: torch.Tensor) -> torch.Tensor:
    """`sqrt(x)` correctly rounded to x's dtype on every device: taken in
    float64 and rounded once, which for float32 gives the correctly rounded
    float32 root (53 >= 2 * 24 + 2 bits), as numpy's, the JAX package's and
    the card's float32 `sqrt` do. torch's float32 `sqrt` on the CPU is not
    always correctly rounded."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _top_from_eigh(evals, evecs, r: int):
    """`(s, v)`: the top `r` pairs of an ascending eigendecomposition of a
    column Gram, as singular values and right singular vectors."""
    evals = torch.flip(evals, dims=(-1,))[..., :r]
    v = torch.flip(evecs, dims=(-1,))[..., :, :r]
    return rounded_sqrt(torch.clamp(evals, min=0.0)), v


def left_factor(x: torch.Tensor, s: torch.Tensor, v: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """`u = X v / s` (row-local: each row of X gives its row of u). With
    `exact` (the exact path), `X v` is formed from float64 copies and
    rounded to X's dtype once, so every BLAS and device gives the same
    bits; else it is taken in X's dtype (the randomized range finder's and
    the HOSVD codecs'). The division is taken in float64 and rounded once:
    the correctly rounded quotient of the two rounded operands, as the
    CPU's float32 division gives it, on every device."""
    if exact:
        xv = torch.matmul(x.to(torch.float64), v.to(torch.float64)).to(x.dtype)
    else:
        xv = torch.matmul(x, v)
    s = torch.clamp(s, min=_tiny_root(x.dtype))[..., None, :]
    return (xv.to(torch.float64) / s.to(torch.float64)).to(x.dtype)


def gram(x: torch.Tensor) -> torch.Tensor:
    """Column Gram `X^T X` of `(..., M, N)` in X's dtype (the randomized
    range finder's and the HOSVD codecs')."""
    return torch.matmul(x.transpose(-1, -2), x)


def gram64(x: torch.Tensor) -> torch.Tensor:
    """Column Gram `X^T X` of `(..., M, N)` formed from float64 copies, not
    rounded: row shards' `gram64` summed in shard order, then rounded once,
    give `exact_gram` of the whole stack."""
    x = x.to(torch.float64)
    return torch.matmul(x.transpose(-1, -2), x)


def exact_gram(x: torch.Tensor) -> torch.Tensor:
    """The exact path's column Gram: `gram64` rounded to X's dtype once."""
    return gram64(x).to(x.dtype)


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
    return left_factor(x, s, v, exact=False), s, v


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
    solver, exact = gram_path(method, m, n)
    if not exact:
        return randomized_truncated_svd(x, r)
    return _gram_svd(x, r, lambda g: _gram_eig(g, solver))


def gram_path(method: str, m: int, n: int) -> tuple[str, bool]:
    """`(solver, exact)`: how `method` factors an M x N stack by a Gram.

    "randomized" on a tall stack takes the range finder on the float32
    `gram` with `left_factor(exact=False)`: `("randomized", False)`. Every
    other stack takes the exact path (`exact_gram`, or shards' `gram64`
    summed and rounded once; `_gram_eig`; `left_factor`), with "jacobi"'s
    eigensolver or the host's LAPACK: `("jacobi" or "gram", True)`. A wide
    stack takes it under "randomized" too, where the sketch saves nothing.
    """
    if method not in ("gram", "jacobi", "randomized"):
        raise ValueError(f"a Gram path takes 'gram', 'jacobi' or 'randomized', not {method!r}")
    if method == "randomized" and n <= m:
        return "randomized", False
    return ("jacobi" if method == "jacobi" else "gram"), True


def _gram_svd(x: torch.Tensor, r: int, eig, exact: bool = True):
    """`truncated_svd`'s Gram path with the eigensolver `eig`: the eigh of
    the short-side Gram, the long-side factor by one product. `exact`:
    Gram and product from float64 copies (`exact_gram`, `left_factor`);
    else in X's dtype (the HOSVD codecs')."""
    form_gram = exact_gram if exact else gram
    if x.shape[-1] <= x.shape[-2]:
        s, v = _top_from_eigh(*eig(form_gram(x)), r)
        return left_factor(x, s, v, exact), s, v
    # Gram on the short (row) side: G = X X^T, V = X^T U / s.
    xt = x.transpose(-1, -2)
    s, u = _top_from_eigh(*eig(form_gram(xt)), r)
    return u, s, left_factor(xt, s, u, exact)


def shared_truncated_svd(stacks, ranks, method: str = "gram"):
    """Truncated SVDs of several same-N patch stacks through ONE batched eigh.

    `stacks`: `(B_i, M_i, N)` tensors sharing N. Their column Grams are all
    `(N, N)`, so one `eigh` over the concatenated Gram batch (`shared_gram`)
    serves every stack. Returns a list of `(u, s, v)` like `truncated_svd`.
    Every method takes this path, as in the JAX package, where the method
    picks only the solver of the shared eigh: `"jacobi"` takes
    `jacobi_eigh`, and `"svd"` and `"randomized"` give what `"gram"` gives.
    """
    _check_method(method)
    return shared_svd_from_eigh(stacks, ranks, *_gram_eig(shared_gram(stacks), method))


def shared_gram(stacks) -> torch.Tensor:
    """The `(sum B_i, N, N)` batch of several same-N stacks' `exact_gram`s,
    in order: the input of `shared_truncated_svd`'s one eigh."""
    return _flat_grams([exact_gram(x) for x in stacks])


def shared_svd_from_eigh(stacks, ranks, evals, evecs):
    """`shared_truncated_svd` from the ascending eigendecomposition of the
    stacks' `shared_gram`, taken by the caller (the encode pipeline's
    `host_eigh`)."""
    ranks = [min(r, x.shape[-2], x.shape[-1]) for x, r in zip(stacks, ranks)]
    pairs = _split_top_pairs(evals, evecs, [x.shape[:-2] for x in stacks], ranks)
    return [(left_factor(x, s, v), s, v) for x, (s, v) in zip(stacks, pairs)]


def shared_top_pairs(grams, ranks, method: str = "gram"):
    """The top `r` pairs `(s, v)` of several `(B_i, N, N)` Grams of one N,
    through one batched eigh (`_lapack_eigh`, or `jacobi_eigh` for
    "jacobi")."""
    evals, evecs = _gram_eig(_flat_grams(grams), method)
    return _split_top_pairs(evals, evecs, [g.shape[:-2] for g in grams], ranks)


def _flat_grams(grams) -> torch.Tensor:
    n = grams[0].shape[-1]
    if any(g.shape[-1] != n for g in grams):
        raise ValueError("shared_truncated_svd needs stacks of one width N")
    return torch.cat([g.reshape(-1, n, n) for g in grams], dim=0)


def _split_top_pairs(evals, evecs, leads, ranks):
    """The top `r` pairs of each Gram batch of leading shape `lead`, in
    order, from its slice of one eigendecomposition of them all."""
    n = evals.shape[-1]
    out = []
    offset = 0
    for lead, r in zip(leads, ranks):
        size = math.prod(lead)
        ev = evals[offset : offset + size].reshape(lead + (n,))
        evec = evecs[offset : offset + size].reshape(lead + (n, n))
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
    rs = rounded_sqrt(s)
    return pad_rank(u * rs[..., None, :], v * rs[..., None, :], rank)
