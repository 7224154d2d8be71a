"""The port's module classes and Jacobi eigensolver against the JAX
package's.

- `QMF.decompose` equals the port's functional `qmf_decompose` bit for bit
  (on the CPU; on the card both run the BCD kernel). From one init (the JAX
  package's, carried over by `state_from_numpy`) it matches the JAX
  package's `QMF` as the BCD contract asks: more than 85% of factor entries
  equal, loss within 2e-3. `verbose=True` runs the sweeps one by one and
  gives the same factors; on the card it launches the kernel once per sweep.
- `CoordinateDescent` with its identity projection, and with the codec's,
  against the JAX package's: factors within 1e-4 of their scale (identity),
  more than 85% equal (projected).
- `SVDInit` equals `svd_init`; `RandInit` draws integers in its bounds, the
  same for one seed and different for two. It cannot equal the JAX
  package's draws: the generators differ.
- `jacobi_eigh` against the JAX package's `jacobi_eigh` and against
  `torch.linalg.eigh`: eigenvalues within rtol 1e-4 (of the largest),
  eigenvectors |cos| within 1e-3 of 1 on separated spectra, ascending
  order, and the equal-diagonal 2x2 case rotated by 45 degrees.
- `method="jacobi"` through `truncated_svd` and `shared_truncated_svd`.

The JAX package is imported inside the tests that use it, so the `cuda`
tests run on a GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_modules.py
"""

import numpy as np
import pytest
import torch
from torch import nn

import lrf_tpu_torch as lt
from lrf_tpu_torch.ops import bcd, svd
from lrf_tpu_torch.ops.jacobi import jacobi_eigh
from lrf_tpu_torch.utils.transfer import state_from_numpy

RNG = np.random.default_rng(53)
BOUNDS = (-16, 15)


def _stack(b, m, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, m, n)).astype(np.float32)


def _psd(b, n, seed, spread=1.0):
    """`(b, n, n)` symmetric PSD matrices with eigenvalues 1..n scaled, well
    separated (gap ~1 over a top of ~n)."""
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((b, n, n)))[0]
    lam = spread * (np.arange(1, n + 1) + rng.uniform(0, 0.3, (b, n)))
    return ((q * lam[:, None, :]) @ q.transpose(0, 2, 1)).astype(np.float32)


class _FixedInit(nn.Module):
    def __init__(self, state):
        super().__init__()
        self.state = state

    def forward(self, x):
        return self.state


def test_qmf_decompose_equals_functional():
    x = torch.from_numpy(_stack(2, 150, 64, 1))
    model = lt.QMF(rank=5, num_iters=4, bounds=BOUNDS)
    for got, want in zip(model.decompose(x), bcd.qmf_decompose(x, 5, num_iters=4, bounds=BOUNDS)):
        assert torch.equal(got, want)
    for got, want in zip(lt.qmf_decompose_cuda(x, 5, num_iters=4), model.decompose(x)):
        assert torch.equal(got, want)
    rec = model(x)
    assert rec.shape == x.shape
    assert torch.equal(rec, lt.QMF.reconstruct(*model.decompose(x)))


def test_qmf_verbose_runs_the_same_sweeps(capsys):
    x = torch.from_numpy(_stack(1, 96, 64, 2))
    quiet = lt.QMF(rank=4, num_iters=3, bounds=BOUNDS).decompose(x)
    loud = lt.QMF(rank=4, num_iters=3, bounds=BOUNDS, verbose=True).decompose(x)
    for a, b in zip(quiet, loud):
        assert torch.equal(a, b)
    assert capsys.readouterr().out.count("loss =") == 3


@pytest.mark.parametrize("shape,rank", [((2, 150, 64), 6), ((1, 64, 48), 20)])
def test_qmf_from_one_init_matches_jax(shape, rank):
    import jax.numpy as jnp
    import lrf_tpu

    x = _stack(*shape, seed=3)
    jq = lrf_tpu.QMF(rank=rank, num_iters=4, bounds=BOUNDS)
    init = tuple(np.asarray(a) for a in jq.init(jnp.asarray(x)))
    jq.init = lambda _x: tuple(jnp.asarray(a) for a in init)
    uj, vj, wj = (np.asarray(a) for a in jq.decompose(x))
    tq = lt.QMF(rank=rank, num_iters=4, bounds=BOUNDS)
    tq.init = _FixedInit(state_from_numpy(*init, device="cpu"))
    ut, vt, wt = tq.decompose(torch.from_numpy(x))
    np.testing.assert_array_equal(wt.numpy(), wj)
    equal = min((ut.numpy() == uj).mean(), (vt.numpy() == vj).mean())
    assert equal > 0.85, equal
    loss_t = float(lt.QMF.loss(torch.from_numpy(x), ut, vt, wt).mean())
    loss_j = float(np.asarray(lrf_tpu.QMF.loss(jnp.asarray(x), uj, vj, wj)).mean())
    assert abs(loss_t - loss_j) < 2e-3


@pytest.mark.parametrize("projected", [False, True])
def test_coordinate_descent_matches_jax(projected):
    import jax.numpy as jnp
    import lrf_tpu

    x = _stack(2, 80, 64, 4)
    u, v, w = (np.asarray(a) for a in lrf_tpu.svd_init(jnp.asarray(x), 5, bounds=BOUNDS))
    project_j = lrf_tpu.make_project(BOUNDS) if projected else None
    project_t = lt.make_project(BOUNDS) if projected else None
    jcd = lrf_tpu.CoordinateDescent(factor=(0, 1, 2), project=project_j)
    tcd = lt.CoordinateDescent(factor=(0, 1, 2), project=project_t)
    gj = jcd(jnp.asarray(x), tuple(jnp.asarray(a) for a in (u, v, w)))
    gt = tcd(torch.from_numpy(x), state_from_numpy(u, v, w, device="cpu"))
    for a, b in zip(gt[:2], gj[:2]):
        b = np.asarray(b)
        if projected:
            assert (a.numpy() == b).mean() > 0.85
        else:
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max(), rtol=0)
    np.testing.assert_allclose(gt[2].numpy(), np.asarray(gj[2]), rtol=1e-3, atol=1e-3)
    assert lt.CoordinateDescent.update_w is bcd.update_w


def test_svd_init_module_equals_svd_init():
    x = torch.from_numpy(_stack(3, 100, 64, 5))
    for kwargs in (dict(), dict(bounds=BOUNDS), dict(num_levels=31.0), dict(method="jacobi", bounds=BOUNDS)):
        got = lt.SVDInit(rank=7, **kwargs)(x)
        want = lt.svd_init(x, 7, **kwargs)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_rand_init_seeded_in_bounds():
    x = torch.zeros(2, 30, 20)
    u, v = lt.RandInit(rank=4, bounds=(-3, 5), seed=1)(x)
    assert u.shape == (2, 30, 4) and v.shape == (2, 20, 4) and u.dtype == torch.float32
    for f in (u, v):
        assert float(f.min()) >= -3 and float(f.max()) <= 5 and torch.equal(f, f.round())
    assert len(torch.unique(u)) == 9  # every integer of the bounds drawn
    again = lt.RandInit(rank=4, bounds=(-3, 5), seed=1)(x)
    other = lt.RandInit(rank=4, bounds=(-3, 5), seed=2)(x)
    assert torch.equal(again[0], u) and torch.equal(again[1], v)
    assert not torch.equal(other[0], u)


def test_hosvd_module_round_trip():
    import jax.numpy as jnp
    import lrf_tpu

    x = RNG.standard_normal((6, 8, 10)).astype(np.float32)
    core, factors = lt.HOSVD(rank=None).decompose(torch.from_numpy(x))
    np.testing.assert_allclose(lt.HOSVD.reconstruct(core, factors).numpy(), x, atol=1e-4)
    rec_t = lt.HOSVD(rank=(3, 4, 5))(torch.from_numpy(x)).numpy()
    rec_j = np.asarray(lrf_tpu.HOSVD(rank=(3, 4, 5))(jnp.asarray(x)))
    assert np.linalg.norm(rec_t - rec_j) < 1e-4 * np.linalg.norm(rec_j)


@pytest.mark.parametrize("b,n", [(5, 16), (2, 32)])
def test_jacobi_eigh_matches_jax_and_eigh(b, n):
    from lrf_tpu.ops.jacobi import jacobi_eigh as jax_jacobi_eigh

    g = _psd(b, n, seed=n)
    ev_t, vec_t = jacobi_eigh(torch.from_numpy(g))
    ev_j, vec_j = (np.asarray(a) for a in jax_jacobi_eigh(g))
    ev_l, vec_l = torch.linalg.eigh(torch.from_numpy(g).double())
    assert ev_t.dtype == vec_t.dtype == torch.float32
    assert bool((ev_t[:, 1:] >= ev_t[:, :-1]).all())  # ascending
    top = np.abs(ev_j).max()
    np.testing.assert_allclose(ev_t.numpy(), ev_j, rtol=0, atol=1e-4 * top)
    np.testing.assert_allclose(ev_t.numpy(), ev_l.numpy(), rtol=0, atol=1e-4 * top)
    for ref in (vec_j, vec_l.numpy()):
        cos = np.abs(np.einsum("bnr,bnr->br", vec_t.numpy().astype(np.float64), ref))
        np.testing.assert_allclose(cos, 1.0, atol=1e-3)
    # batch-invariant: one matrix alone gives what it gives in the batch
    alone = jacobi_eigh(torch.from_numpy(g[1:2]))
    assert torch.equal(alone[0][0], ev_t[1]) and torch.equal(alone[1][0], vec_t[1])


def test_jacobi_eigh_equal_diagonal_pair():
    ev, vec = jacobi_eigh(torch.tensor([[1.0, 0.5], [0.5, 1.0]]))
    np.testing.assert_allclose(ev.numpy(), [0.5, 1.5], atol=1e-6)
    np.testing.assert_allclose(np.abs(vec.numpy()), np.full((2, 2), 0.5**0.5), atol=1e-6)
    ev, vec = jacobi_eigh(torch.diag(torch.tensor([3.0, 1.0, 2.0, 0.0])))  # already diagonal: a permutation
    np.testing.assert_array_equal(ev.numpy(), [0.0, 1.0, 2.0, 3.0])
    assert torch.equal(vec.abs().sum(0), torch.ones(4))
    with pytest.raises(ValueError, match="even N"):
        jacobi_eigh(torch.eye(3))


def test_jacobi_method_through_truncated_svd():
    import jax.numpy as jnp
    from lrf_tpu.ops import svd as jsvd

    rng = np.random.default_rng(61)
    q_l = np.linalg.qr(rng.standard_normal((2, 120, 16)))[0]
    q_r = np.linalg.qr(rng.standard_normal((2, 16, 16)))[0]
    x = ((q_l * 50.0 * 0.7 ** np.arange(16)) @ q_r.transpose(0, 2, 1)).astype(np.float32)
    for xs in (x, np.ascontiguousarray(x.transpose(0, 2, 1))):  # column Gram, then row Gram
        u, s, v = svd.truncated_svd(torch.from_numpy(xs), 5, method="jacobi")
        ju, js, jv = (np.asarray(a) for a in jsvd.truncated_svd(jnp.asarray(xs), 5, method="jacobi"))
        np.testing.assert_allclose(s.numpy(), js, rtol=1e-4)
        for a, b in ((u.numpy(), ju), (v.numpy(), jv)):
            np.testing.assert_allclose(np.abs(np.einsum("...nr,...nr->...r", a, b)), 1.0, atol=1e-3)
    shared = svd.shared_truncated_svd([torch.from_numpy(x), torch.from_numpy(x[:1])], [5, 3], "jacobi")
    for (u, s, v), r in zip(shared, (5, 3)):
        ref = svd.truncated_svd(torch.from_numpy(x[: u.shape[0]]), r, method="jacobi")
        np.testing.assert_allclose(s.numpy(), ref[1].numpy(), rtol=1e-5)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the BCD kernel has no CPU mode)")


@pytest.mark.cuda
def test_qmf_module_launches_the_kernel_on_gpu():
    # QMF.decompose and qmf_decompose_cuda run the kernel the functional
    # qmf_decompose runs, one launch each, with the same bits.
    _cuda()
    from lrf_tpu_torch.ops import bcd_kernel

    x = torch.from_numpy(_stack(1, 6144, 64, 6)).cuda()
    want = bcd.qmf_decompose(x, 6, bounds=BOUNDS)
    before = dict(bcd_kernel.KERNEL.counts)
    got = lt.QMF(rank=6, bounds=BOUNDS).decompose(x)
    assert bcd_kernel.KERNEL.counts["bcd_cluster"] == before["bcd_cluster"] + 1
    again = lt.qmf_decompose_cuda(x, 6, bounds=BOUNDS)
    assert bcd_kernel.KERNEL.counts["bcd_cluster"] == before["bcd_cluster"] + 2
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_qmf_verbose_launches_the_kernel_each_sweep_on_gpu(capsys):
    # verbose=True takes the kernel too, one launch per sweep, same bits.
    _cuda()
    from lrf_tpu_torch.ops import bcd_kernel

    x = torch.from_numpy(_stack(1, 6144, 64, 7)).cuda()
    quiet = lt.QMF(rank=6, num_iters=10, bounds=BOUNDS).decompose(x)
    before = dict(bcd_kernel.KERNEL.counts)
    loud = lt.QMF(rank=6, num_iters=10, bounds=BOUNDS, verbose=True).decompose(x)
    after = dict(bcd_kernel.KERNEL.counts)
    assert {k: after[k] - before[k] for k in after} == {k: 10 if k == "bcd_cluster" else 0 for k in after}
    assert capsys.readouterr().out.count("loss =") == 10
    for a, b in zip(quiet, loud):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_jacobi_eigh_on_gpu():
    _cuda()
    g = torch.from_numpy(_psd(8, 64, seed=9)).cuda()
    ev, vec = jacobi_eigh(g)
    ev_l, vec_l = torch.linalg.eigh(g.double())
    torch.testing.assert_close(ev.double(), ev_l, rtol=0, atol=1e-4 * float(ev_l.abs().max()))
    cos = (vec.double() * vec_l).sum(-2).abs()
    torch.testing.assert_close(cos, torch.ones_like(cos), rtol=0, atol=1e-3)
