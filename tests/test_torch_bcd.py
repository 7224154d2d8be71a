"""The port's SVD init and BCD solver against the JAX package's.

The BCD comparisons start both packages from ONE init (the JAX package's
`svd_init`, carried over by `state_from_numpy`), which takes eigh's sign and
order differences out. Tolerance, as for the Pallas kernel in
`tests/test_bcd_pallas.py`: mean loss within 2e-3 and more than 85% of
factor entries equal, because matmul order differs and round() ties flip.

The CUDA kernel itself runs only on a GPU; its tests are in
`tests/test_torch_kernel.py`, which imports no JAX.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lrf_tpu.ops import bcd as jbcd
from lrf_tpu.ops.bcd_pallas import bcd_pallas
from lrf_tpu.ops import svd as jsvd
from lrf_tpu_torch.ops import bcd, bcd_kernel, svd
from lrf_tpu_torch.utils.transfer import state_from_numpy

RNG = np.random.default_rng(17)
SHAPES = [(3, 300, 64, 7), (2, 257, 64, 5), (1, 64, 64, 1), (2, 128, 64, 26)]


def _jax_reference(x, u0, v0, iters, bounds):
    w = jnp.concatenate([jnp.zeros_like(x[..., :1, :1]), jnp.ones_like(x[..., :1, :1])], axis=-2)
    proj = jbcd.make_project(bounds)
    u, v = u0, v0
    for _ in range(iters):
        u, v, w = jbcd.bcd_sweep(x, u, v, w, factor=(0, 1), project=proj)
    return np.asarray(u), np.asarray(v)


def _close(x, u_a, v_a, u_b, v_b):
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    loss_a = float(bcd.qmf_loss(t(x), t(u_a), t(v_a)).mean())
    loss_b = float(bcd.qmf_loss(t(x), t(u_b), t(v_b)).mean())
    assert abs(loss_a - loss_b) < 2e-3, (loss_a, loss_b)
    assert float((np.asarray(u_a) == np.asarray(u_b)).mean()) > 0.85
    assert float((np.asarray(v_a) == np.asarray(v_b)).mean()) > 0.85


@pytest.mark.parametrize("b,m,n,r", SHAPES)
def test_plain_bcd_matches_jax_and_pallas(b, m, n, r):
    x = RNG.integers(0, 256, (b, m, n)).astype(np.float32)
    u0, v0, _ = jbcd.svd_init(jnp.asarray(x), r, bounds=(-16, 15))
    uj, vj = _jax_reference(jnp.asarray(x), u0, v0, 4, (-16, 15))
    up, vp = bcd_pallas(jnp.asarray(x), u0, v0, num_iters=4, bounds=(-16, 15), interpret=True)
    ut0, vt0 = state_from_numpy(np.asarray(u0), np.asarray(v0), device="cpu")
    ut, vt = bcd_kernel.bcd(torch.from_numpy(x), ut0, vt0, num_iters=4, bounds=(-16, 15))
    assert ut.shape == (b, m, r) and vt.shape == (b, n, r) and ut.dtype == torch.float32
    for f in (ut, vt):
        assert torch.all(f == torch.round(f)) and f.min() >= -16 and f.max() <= 15
    _close(x, ut.numpy(), vt.numpy(), uj, vj)
    _close(x, ut.numpy(), vt.numpy(), up, vp)


def test_bounds_and_integrality():
    x = torch.from_numpy(RNG.integers(0, 256, (2, 200, 64)).astype(np.float32))
    u, v, w = bcd.qmf_decompose(x, rank=6, num_iters=3, bounds=(-8, 7))
    for f in (u, v):
        assert torch.all(f == torch.round(f))
        assert f.min() >= -8 and f.max() <= 7
    np.testing.assert_array_equal(w[..., 0, 0].numpy(), 0.0)
    np.testing.assert_array_equal(w[..., 1, 0].numpy(), 1.0)


def test_zero_iters_returns_init():
    x = RNG.integers(0, 256, (1, 128, 64)).astype(np.float32)
    u0, v0, _ = jbcd.svd_init(jnp.asarray(x), 4)
    ut0, vt0 = state_from_numpy(np.asarray(u0), np.asarray(v0), device="cpu")
    u, v = bcd_kernel.bcd(torch.from_numpy(x), ut0, vt0, num_iters=0)
    np.testing.assert_array_equal(u.numpy(), np.asarray(u0))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v0))


def test_bcd_from_init_matches_reference_on_cpu():
    # The same loop through `bcd_from_init` (w given) and the plain version.
    x = torch.from_numpy(RNG.integers(0, 256, (2, 96, 64)).astype(np.float32))
    init = bcd.svd_init(x, 5, bounds=(-16, 15))
    u, v, _ = bcd.bcd_from_init(x, init, num_iters=3, bounds=(-16, 15))
    ur, vr = bcd_kernel.bcd_reference(x, init[0], init[1], num_iters=3, bounds=(-16, 15))
    assert torch.equal(u, ur) and torch.equal(v, vr)


@pytest.mark.parametrize("shape,rank", [((3, 200, 64), 6), ((2, 40, 96), 7), ((1, 64, 64), 64)])
def test_svd_init_matches_jax_up_to_signs(shape, rank):
    x = RNG.integers(0, 256, shape).astype(np.float32)
    _, s_t, _ = svd.truncated_svd(torch.from_numpy(x), rank)
    _, s_j, _ = jsvd.truncated_svd(jnp.asarray(x), rank)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=2e-3, atol=1e-2 * float(np.asarray(s_j).max()))
    u_t, v_t, w_t = bcd.svd_init(torch.from_numpy(x), rank, bounds=(-16, 15))
    u_j, v_j, w_j = jbcd.svd_init(jnp.asarray(x), rank, bounds=(-16, 15))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    # u v^T is sign-free: the products agree where the leading components do.
    rec_t = bcd.qmf_reconstruct(u_t, v_t).numpy()
    rec_j = np.asarray(jbcd.qmf_reconstruct(u_j, v_j))
    assert np.abs(rec_t - rec_j).max() < 1e-2 * np.abs(x).max()


def test_shared_init_equals_per_stack_init():
    a = torch.from_numpy(RNG.integers(0, 256, (2, 96, 64)).astype(np.float32))
    b = torch.from_numpy(RNG.integers(0, 256, (4, 80, 64)).astype(np.float32))
    shared = bcd.svd_init_shared([a, b], [5, 3], bounds=(-16, 15))
    for x, r, (u, v, w) in zip((a, b), (5, 3), shared):
        u1, v1, w1 = bcd.svd_init(x, r, bounds=(-16, 15))
        torch.testing.assert_close(u, u1, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(v, v1, atol=1e-4, rtol=1e-4)


def test_unported_svd_methods_raise():
    x = torch.zeros(1, 64, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        svd.truncated_svd(x, 4, method="jacobi")
    with pytest.raises(ValueError, match="unknown SVD method"):
        svd.truncated_svd(x, 4, method="qr")


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError):
        bcd_kernel.bcd(x, torch.zeros(2, 64, 3), torch.zeros(2, 63, 3))
    with pytest.raises(ValueError):
        bcd_kernel.bcd(x[0], torch.zeros(64, 3), torch.zeros(64, 3))

