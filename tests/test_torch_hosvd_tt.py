"""The port's HOSVD, tensor-train and HOSVD codecs against the JAX
package's, on the CPU.

- The rank-bound, feasible-range and rank-for-ratio helpers are equal.
- `unfold` is equal; the mode products agree within 1e-6 of the result's
  largest magnitude (float32 sums in another order).
- `hosvd`, `batched_hosvd`, `ttd` and `batched_ttd` reconstruct within 1e-4
  relative of the JAX package's reconstruction, and their factors are the
  JAX package's up to the sign of each column (|cos| within 1e-3), at ranks
  where the spectra are separated.
- The HOSVD's mode eigensolver (`ops/svd.py::_lapack_eigh`) gives
  `jnp.linalg.eigh`'s eigenvalues and eigenvector signs on one seeded Gram
  of each n in (3, 8, 64, 192): both are LAPACK's `?syevd`.
- Both HOSVD codecs: the same rank tuples (the patch codec's SSIM search
  included) and shapes, dicts of the same keys, types and dtypes; each
  package decodes the other's dict to the pixels the other decodes (at most
  1 apart in under 0.1% of pixels); odd sizes take the padding path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lrf_tpu
import lrf_tpu_torch
from lrf_tpu.ops.hosvd import hosvd as jhosvd
from lrf_tpu.ops import tt as jtt
from lrf_tpu_torch.ops.hosvd import hosvd as hosvd_fn
from lrf_tpu_torch.ops import tt as ptt
from lrf_tpu_torch.ops.svd import _lapack_eigh

import torch_images

RNG = np.random.default_rng(41)


@pytest.fixture(scope="module")
def unit_crop():
    return torch_images.photos(1, 48, 64, seed=7)[0].astype(np.float32) / 255.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _same_up_to_sign(a, b, axis=-2):
    """Columns (vectors along `axis`) equal up to sign: |cos| within 1e-3 of 1."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = (a * b).sum(axis) / (np.linalg.norm(a, axis=axis) * np.linalg.norm(b, axis=axis))
    np.testing.assert_allclose(np.abs(cos), 1.0, atol=1e-3)


@pytest.mark.parametrize("size", [(3, 48, 64), (96, 8, 8, 3), (5, 7), (2, 3, 4, 5)])
@pytest.mark.parametrize("ratio", [4.0, 20.0])
def test_rank_helpers_equal(size, ratio):
    assert lrf_tpu_torch.hosvd_rank_upper_bounds(size) == lrf_tpu.hosvd_rank_upper_bounds(size)
    assert lrf_tpu_torch.hosvd_rank_feasible_ranges(size, ratio) == lrf_tpu.hosvd_rank_feasible_ranges(size, ratio)
    fixed = (None,) * (len(size) - 1) + (size[-1],)
    assert lrf_tpu_torch.hosvd_rank_feasible_ranges(size, ratio, fixed) == lrf_tpu.hosvd_rank_feasible_ranges(
        size, ratio, fixed)
    assert lrf_tpu_torch.tt_rank_upper_bounds(size) == lrf_tpu.tt_rank_upper_bounds(size)
    assert lrf_tpu_torch.tt_rank_feasible_ranges(size, ratio) == lrf_tpu.tt_rank_feasible_ranges(size, ratio)
    if len(size) == 3:
        assert lrf_tpu_torch.hosvd_rank(size, ratio) == lrf_tpu.hosvd_rank(size, ratio)
    rank = tuple(max(1, s // 2) for s in size)
    assert lrf_tpu_torch.hosvd_compression_ratio(size, rank) == lrf_tpu.hosvd_compression_ratio(size, rank)
    assert lrf_tpu_torch.hosvd_compression_ratio(size, 2) == lrf_tpu.hosvd_compression_ratio(size, 2)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)


def test_unfold_and_mode_products():
    x = RNG.standard_normal((4, 6, 5)).astype(np.float32)
    xt = torch.from_numpy(x)
    for mode in range(3):
        np.testing.assert_array_equal(lrf_tpu_torch.unfold(xt, mode).numpy(), np.asarray(lrf_tpu.unfold(x, mode)))
    mats = [RNG.standard_normal((3, n)).astype(np.float32) for n in x.shape]
    for mode, m in enumerate(mats):
        for transpose, mm in ((False, m), (True, np.ascontiguousarray(m.T))):
            got = lrf_tpu_torch.mode_product(xt, torch.from_numpy(mm), mode, transpose=transpose)
            want = lrf_tpu.mode_product(jnp.asarray(x), jnp.asarray(mm), mode, transpose=transpose)
            _close(got, want)
    got = lrf_tpu_torch.multi_mode_product(xt, [torch.from_numpy(m) for m in mats[1:]], modes=[1, 2])
    want = lrf_tpu.multi_mode_product(jnp.asarray(x), [jnp.asarray(m) for m in mats[1:]], modes=[1, 2])
    _close(got, want)
    xb = RNG.standard_normal((2, 4, 6, 5)).astype(np.float32)
    mb = [RNG.standard_normal((2, n, 3)).astype(np.float32) for n in xb.shape[1:]]
    got = lrf_tpu_torch.batched_multi_mode_product(torch.from_numpy(xb), [torch.from_numpy(m) for m in mb],
                                                   transpose=True)
    want = lrf_tpu.batched_multi_mode_product(jnp.asarray(xb), [jnp.asarray(m) for m in mb], transpose=True)
    _close(got, want)


@pytest.mark.parametrize("rank", [(3, 12, 12), (2, 6, 20)])
def test_hosvd_matches_jax(unit_crop, rank):
    core_t, fac_t = hosvd_fn(torch.from_numpy(unit_crop), rank=rank)
    core_j, fac_j = jhosvd(jnp.asarray(unit_crop), rank=rank)
    assert tuple(core_t.shape) == tuple(core_j.shape) == rank
    for a, b in zip(fac_t, fac_j):
        _same_up_to_sign(a.numpy(), b)
    rec_t = lrf_tpu_torch.multi_mode_product(core_t, fac_t)
    rec_j = lrf_tpu.multi_mode_product(core_j, fac_j)
    assert _rel(rec_t.numpy(), rec_j) < 1e-4
    # the module class round-trips through the same functions
    np.testing.assert_array_equal(lrf_tpu_torch.HOSVD(rank)(torch.from_numpy(unit_crop)).numpy(), rec_t.numpy())


@pytest.mark.parametrize("n", [3, 8, 64, 192])
def test_lapack_eigh_signs_are_jax_eigh_signs(n):
    # One seeded Gram, the same bits through both: the HOSVD's eigensolver
    # must give jnp.linalg.eigh's eigenvalues and eigenvector signs.
    rng = np.random.default_rng(100 + n)
    x = rng.standard_normal((3, 2 * n + 5, n)).astype(np.float32)
    g = np.einsum("bij,bik->bjk", x, x)
    g = (g + g.transpose(0, 2, 1)) / np.float32(2)
    w_t, v_t = _lapack_eigh(torch.from_numpy(g))
    w_j, v_j = jnp.linalg.eigh(jnp.asarray(g))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-5 * float(np.abs(w_j).max()))
    cos = (v_t.numpy().astype(np.float64) * np.asarray(v_j, np.float64)).sum(-2)
    assert np.all(cos > 0.9), cos.min()
    assert v_t.dtype == torch.float32 and tuple(v_t.shape) == g.shape


def test_batched_hosvd_matches_jax(unit_crop):
    x = np.stack([unit_crop, unit_crop[:, ::-1, :]]).copy()
    core_t, fac_t = lrf_tpu_torch.batched_hosvd(torch.from_numpy(x), rank=(3, 10, 10))
    core_j, fac_j = lrf_tpu.batched_hosvd(jnp.asarray(x), rank=(3, 10, 10))
    for a, b in zip(fac_t, fac_j):
        _same_up_to_sign(a.numpy(), b)
    rec_t = lrf_tpu_torch.batched_multi_mode_product(core_t, fac_t)
    assert _rel(rec_t.numpy(), lrf_tpu.batched_multi_mode_product(core_j, fac_j)) < 1e-4
    single, _ = hosvd_fn(torch.from_numpy(x[1]), rank=(3, 10, 10))
    assert _rel(lrf_tpu_torch.multi_mode_product(single, [f[1] for f in fac_t]).numpy(), rec_t[1].numpy()) < 1e-5


@pytest.mark.parametrize("rank", [None, (3, 12), 6])
def test_ttd_matches_jax(unit_crop, rank):
    fac_t = ptt.ttd(torch.from_numpy(unit_crop), rank)
    fac_j = jtt.ttd(jnp.asarray(unit_crop), rank)
    assert [tuple(f.shape) for f in fac_t] == [tuple(f.shape) for f in fac_j]
    if rank is not None:  # truncated: separated singular values
        _same_up_to_sign(fac_t[0].numpy(), fac_j[0])
    rec_t = lrf_tpu_torch.contract_tt(fac_t)
    assert rec_t.shape == unit_crop.shape
    assert _rel(rec_t.numpy(), lrf_tpu.contract_tt(fac_j)) < 1e-4


def test_batched_ttd_matches_jax(unit_crop):
    x = np.stack([unit_crop, unit_crop[::-1]]).copy()
    fac_t = lrf_tpu_torch.batched_ttd(torch.from_numpy(x), (3, 10))
    fac_j = lrf_tpu.batched_ttd(jnp.asarray(x), (3, 10))
    assert [tuple(f.shape) for f in fac_t] == [tuple(f.shape) for f in fac_j]
    rec_t = lrf_tpu_torch.batched_contract_tt(fac_t)
    assert _rel(rec_t.numpy(), lrf_tpu.batched_contract_tt(fac_j)) < 1e-4
    one = ptt.ttd(torch.from_numpy(x[1]), (3, 10))
    assert _rel(lrf_tpu_torch.contract_tt(one).numpy(), rec_t[1].numpy()) < 1e-5


def _check_dicts(d_t, d_j):
    assert d_t.keys() == d_j.keys()
    for key in d_j.keys() - {"core", "factors"}:  # the sizes
        assert isinstance(d_t[key], np.ndarray) and d_t[key].dtype == d_j[key].dtype
        np.testing.assert_array_equal(d_t[key], d_j[key])
    for a, b in zip([d_t["core"], *d_t["factors"]], [d_j["core"], *d_j["factors"]]):
        assert type(a) is type(b)
        if isinstance(b, tuple):
            assert isinstance(a[0], np.ndarray) and a[0].dtype == np.asarray(b[0]).dtype
            assert a[0].shape == np.asarray(b[0]).shape and type(a[1]) is type(b[1]) is float
        else:
            assert a.dtype == np.asarray(b).dtype and a.shape == np.asarray(b).shape


def _cross_decode(decode_t, decode_j, d_t, d_j):
    for d in (d_t, d_j):
        by_port = decode_t(d, device="cpu")
        by_jax = np.asarray(decode_j(d))
        assert by_port.dtype == np.uint8 and by_port.shape == by_jax.shape
        diff = np.abs(by_port.astype(np.int16) - by_jax.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("size,dtype", [((32, 48), None), ((29, 45), np.float32)])
def test_hosvd_codec(size, dtype):
    img = torch_images.photos(1, *size, seed=8)[0]
    d_t = lrf_tpu_torch.hosvd_encode(img, com_ratio=20, dtype=dtype, device="cpu")
    d_j = lrf_tpu.hosvd_encode(img, com_ratio=20, dtype=dtype)
    _check_dicts(d_t, d_j)
    _cross_decode(lrf_tpu_torch.hosvd_decode, lrf_tpu.hosvd_decode, d_t, d_j)


@pytest.mark.parametrize("size,kwargs", [((32, 48), dict(bpp=1.0)), ((29, 45), dict(com_ratio=12.0, dtype=np.float32))])
def test_patch_hosvd_codec(size, kwargs):
    img = torch_images.photos(1, *size, seed=9)[0]
    d_t = lrf_tpu_torch.patch_hosvd_encode(img, device="cpu", **kwargs)
    d_j = lrf_tpu.patch_hosvd_encode(img, **kwargs)
    _check_dicts(d_t, d_j)  # rank tuples: the factor shapes
    if size[0] % 8:
        assert tuple(d_t["padded size"]) == (32, 48) and tuple(d_t["original size"]) == size
    _cross_decode(lrf_tpu_torch.patch_hosvd_decode, lrf_tpu.patch_hosvd_decode, d_t, d_j)


def test_patch_hosvd_tensorize_and_rank_search():
    img = torch_images.photos(1, 32, 48, seed=9)[0]
    x = torch.from_numpy(img.astype(np.float32) / 255.0)
    tensor = lrf_tpu_torch.patch_hosvd_tensorize(x)
    np.testing.assert_array_equal(tensor.numpy(), np.asarray(lrf_tpu.patch_hosvd_tensorize(jnp.asarray(x.numpy()))))
    np.testing.assert_array_equal(lrf_tpu_torch.patch_hosvd_detensorize(tensor, (32, 48)).numpy(), x.numpy())
    # the SSIM search picks the JAX package's ranks on this crop (bpp 1.0:
    # the ratio 24 of `test_patch_hosvd_codec`'s first case)
    rank_t = lrf_tpu_torch.patch_hosvd_optimal_rank(img, 24.0, device="cpu")
    assert rank_t == lrf_tpu.patch_hosvd_optimal_rank(img, 24.0)
    assert all(isinstance(r, int) for r in rank_t)
