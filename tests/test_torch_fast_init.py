"""The port's opt-in fast init against the JAX package's.

- `truncated_svd(method="randomized")` against `lrf_tpu.ops.svd`'s on the
  same stacks: squared singular values within Weyl's bound for two float32
  Grams (below), subspaces agreeing (|diag(VᵀV_jax)| >= 1 - 1e-3); the
  wide-matrix fallback to the exact Gram path; determinism; an exact
  low-rank matrix recovered.
- `init="fast"` encodes against the JAX package's fast encodes on kodim01
  crops, cross-decoded both ways: per-image PSNR within 0.05 dB.
- The RD bound of the JAX package's own contract: per image at q10 the
  fast init's PSNR >= the exact init's - 0.3 dB.
- The default equals an explicit `init="svd"`; an unknown init raises;
  all-black and all-gray images give finite factors and near-exact pixels.

The JAX package is imported inside the tests that use it, so the `cuda`
test runs on a GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_fast_init.py
"""

import numpy as np
import pytest
import torch

import lrf_tpu_torch as lt
from lrf_tpu_torch.ops import svd as tsvd
from lrf_tpu_torch.ops.color import rgb_to_ycbcr
from lrf_tpu_torch.ops.patch import patchify
from torch_images import kodim01, photos


def _psnr(ref, dec):
    return float(lt.psnr(ref, dec))


@pytest.fixture(scope="module")
def batch():
    img = kodim01()
    return np.stack([np.ascontiguousarray(img[:, 40 * i : 40 * i + 96, 60 * i : 60 * i + 128]) for i in range(4)])


def _y_stacks(images) -> torch.Tensor:
    """The Y patch stacks `(B, M, 64)` of RGB images, float32."""
    return patchify(rgb_to_ycbcr(torch.from_numpy(images).to(torch.float32))[:, :1], (8, 8))


@pytest.mark.parametrize("rank", [3, 6, 13])
def test_randomized_matches_jax(rank):
    """The two range finders differ only in how their float32 Grams are
    summed. Weyl's inequality bounds the gaps of the Gram's eigenvalues by
    ‖ΔG‖₂, and two float32 Grams of M rows of nonnegative values, summed in
    any order, keep ‖ΔG‖₂ <= 2·M·2⁻²⁴·s₀²: so |s_i² - s_jax,i²| is held
    within that, relative to the leading s_jax,0². The bound replaced
    `rtol=1e-4` on s once the port's color transform gave the JAX package's
    X: index 11 at rank 13 then read 1.304e-4 apart (s = 258.4 against
    s₀ ≈ 16,000). Against s_jax,0² the largest gap read 2.15e-6 on the
    port's old X and 8.5e-7 on the JAX package's, against a bound of
    2.29e-5 at M = 192: tighter than 1e-4 at s₀ (about 1.1e-5 relative),
    looser on the trailing Ritz values.
    """
    import jax.numpy as jnp

    from lrf_tpu.ops import svd as jsvd

    x = _y_stacks(photos(3, 96, 128, seed=rank)).contiguous()
    assert x.shape == (3, 192, 64)
    u, s, v = tsvd.truncated_svd(x, rank, method="randomized")
    uj, sj, vj = (np.asarray(a) for a in jsvd.truncated_svd(jnp.asarray(x.numpy()), rank, method="randomized"))
    assert u.shape == (3, 192, rank) and s.shape == (3, rank) and v.shape == (3, 64, rank)
    s2, sj2 = s.numpy().astype(np.float64) ** 2, sj.astype(np.float64) ** 2
    weyl = 2 * x.shape[-2] * 2.0**-24 * sj2[:, :1]
    assert bool(np.all(np.abs(s2 - sj2) <= weyl)), (np.abs(s2 - sj2) / sj2[:, :1]).max()
    overlap = np.abs(np.einsum("bnr,bnr->br", v.numpy(), vj))
    assert overlap.min() >= 1 - 1e-3, overlap.min()
    # Ritz values bound the exact ones from below (up to float32 rounding),
    # and the sketch captures nearly all of the exact top subspace's energy
    exact = tsvd.truncated_svd(x, rank, method="gram")[1]
    assert bool(torch.all(s <= exact * (1 + 1e-3)))
    captured = (s**2).sum(-1) / (exact**2).sum(-1)
    assert float(captured.min()) > 0.995, captured


def test_randomized_recovers_exact_low_rank():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((200, 5)), rng.standard_normal((64, 5))
    x = torch.from_numpy(a @ np.diag([100.0, 50, 20, 10, 5]) @ b.T).to(torch.float32)
    u, s, v = tsvd.randomized_truncated_svd(x, 5)
    np.testing.assert_allclose(s.numpy(), tsvd.truncated_svd(x, 5)[1].numpy(), rtol=1e-3)
    np.testing.assert_allclose((u * s) @ v.T, x, rtol=1e-2, atol=1e-2)
    with pytest.raises(ValueError, match="tall"):
        tsvd.randomized_truncated_svd(x.T.contiguous(), 5)


def test_wide_matrix_falls_back_to_gram():
    import jax.numpy as jnp

    from lrf_tpu.ops import svd as jsvd

    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 32, 64))).to(torch.float32)
    got = tsvd.truncated_svd(x, 4, method="randomized")
    exact = tsvd.truncated_svd(x, 4, method="gram")
    for g, e in zip(got, exact):
        assert torch.equal(g, e)
    sj = np.asarray(jsvd.truncated_svd(jnp.asarray(x.numpy()), 4, method="randomized")[1])
    np.testing.assert_allclose(got[1].numpy(), sj, rtol=1e-4)


def test_randomized_deterministic():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 500, 64))).to(torch.float32)
    a = tsvd.truncated_svd(x, 6, method="randomized")
    b = tsvd.truncated_svd(x, 6, method="randomized")
    for xa, xb in zip(a, b):
        assert torch.equal(xa, xb)


def test_fast_encode_matches_jax_cross_decoded(batch):
    import jax

    import lrf_tpu
    from lrf_tpu.parallel.encode import sharded_qmf_encode_batch
    from lrf_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, patch=1, devices=jax.devices()[:1])
    want = sharded_qmf_encode_batch(batch, mesh, quality=10, init="fast")
    got = lt.sharded_qmf_encode_batch(batch, quality=10, init="fast", device="cpu")
    assert got != lt.sharded_qmf_encode_batch(batch, quality=10, device="cpu")  # the init did change
    for i in range(len(batch)):
        ours_by_jax = np.asarray(lrf_tpu.qmf_decode(got[i]))
        jax_by_ours = lt.qmf_decode(want[i], device="cpu")
        np.testing.assert_array_equal(ours_by_jax, lt.qmf_decode(got[i], device="cpu"))
        np.testing.assert_array_equal(jax_by_ours, np.asarray(lrf_tpu.qmf_decode(want[i])))
        assert abs(_psnr(batch[i], ours_by_jax) - _psnr(batch[i], jax_by_ours)) < 0.05, i


def test_fast_init_rd_bound_q10(batch):
    exact = lt.sharded_qmf_encode_batch(batch, quality=10, device="cpu")
    fast = lt.sharded_qmf_encode_batch(batch, quality=10, init="fast", device="cpu")
    for i in range(len(batch)):
        p_e = _psnr(batch[i], lt.qmf_decode(exact[i], device="cpu"))
        p_f = _psnr(batch[i], lt.qmf_decode(fast[i], device="cpu"))
        assert p_f >= p_e - 0.3, (i, p_e, p_f)
    # deterministic, and the pipelined encoder takes the same init
    assert lt.sharded_qmf_encode_batch(batch, quality=10, init="fast", device="cpu") == fast
    assert list(lt.sharded_qmf_encode_batches([batch], quality=10, init="fast", device="cpu")) == [fast]


def test_default_init_is_svd(batch):
    assert lt.sharded_qmf_encode_batch(batch, quality=10, device="cpu") == lt.sharded_qmf_encode_batch(
        batch, quality=10, init="svd", device="cpu"
    )


def test_unknown_init_rejected():
    with pytest.raises(ValueError, match="'svd', 'fast'"):
        lt.build_sharded_encoder("cpu", (96, 128), quality=10, batch=4, init="typo")


def test_fast_init_black_and_gray_images():
    images = np.zeros((2, 3, 48, 64), np.uint8)
    images[1] = 128
    for stream, img in zip(lt.sharded_qmf_encode_batch(images, quality=10, init="fast", device="cpu"), images):
        out = lt.qmf_decode(stream, device="cpu")
        assert out.shape == img.shape
        assert int(np.abs(out.astype(np.int32) - img).max()) <= 2
    x = torch.zeros(2, 96, 64)
    u, s, v = tsvd.truncated_svd(x, 6, method="randomized")
    assert bool(torch.isfinite(u).all() and torch.isfinite(s).all() and torch.isfinite(v).all())


@pytest.mark.cuda
def test_fast_init_rd_bound_on_gpu(batch):
    # The JAX package's contract on the card: per image at q10 the fast
    # init's PSNR >= the exact init's - 0.3 dB; the cluster kernel runs
    # twice per encode either way.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the BCD kernel has no CPU mode)")
    from lrf_tpu_torch.ops import bcd_kernel

    images = batch
    exact = lt.sharded_qmf_encode_batch(images, quality=10)
    before = bcd_kernel.KERNEL.counts["bcd_cluster"]
    fast = lt.sharded_qmf_encode_batch(images, quality=10, init="fast")
    assert bcd_kernel.KERNEL.counts["bcd_cluster"] == before + 2
    assert lt.sharded_qmf_encode_batch(images, quality=10, init="fast") == fast
    for i, img in enumerate(images):
        p_e = _psnr(img, lt.qmf_decode(exact[i], device="cpu"))
        p_f = _psnr(img, lt.qmf_decode(fast[i], device="cpu"))
        assert p_f >= p_e - 0.3, (i, p_e, p_f)
