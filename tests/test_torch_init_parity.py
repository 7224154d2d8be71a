"""The QMF init and the color transform give one result on every device.

On the CPU, on the seven `experiments/data/local7` photographs:

- `rgb_to_ycbcr` and `ycbcr_to_rgb` equal the JAX package's bit for bit
  (`np.array_equal`), forward on the photograph and back on its YCbCr with
  and without seeded noise;
- the exact init's Gram (`ops/svd.py::exact_gram`) equals a float64 numpy
  Gram rounded to float32 in every entry of each Y stack, and does not
  depend on how the rows are sharded: 1, 2 and 3 row shards' `gram64`
  summed by `sum_shards`, then rounded, give the same bits;
- the exact init's eigensolver is `_lapack_eigh` (LAPACK's `?syevd`, one
  native call per batch) for `method="gram"`, bit for bit, and the init
  never calls `torch.linalg.eigh`; its LAPACK call runs on one OpenBLAS
  thread, which is restored after, and every host LAPACK loop holds the
  gate (`svd._GATE`) in the mode it needs: the eigh of small Grams shares
  it on one thread, the eigh of large Grams and the SVD codec's `?gesdd`
  hold it alone on the count found (`tests/test_torch_host_eigh.py` holds
  the native batch's bits and the gate's overlap);
- `gram_path` states which stacks take the exact path, for
  `truncated_svd` and `sharded_svd_init` alike;
- `left_factor` gives a stack's bits and its row shards' alike, and a
  patch-sharded init (`sharded_svd_init` on CPU "devices") equals the
  unsharded `svd_init_shared` for the tall Y and Cb+Cr stacks;
- the init's square roots and its division, taken in float64 and rounded
  once so that the card gives the correctly rounded results, are numpy's
  float32 `sqrt` (correctly rounded, as the JAX package's is; torch's
  CPU float32 `sqrt` is not always) and the CPU's float32 division, bit
  for bit.

On a GPU (`cuda`), the exact init's U and V on the card equal the CPU's on
two photographs at q10 and q40.

About 15 s on one core of this host. JAX is imported inside the color
test, so that the `cuda` case runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_init_parity.py
"""

import glob
import os

import numpy as np
import pytest
import torch

from lrf_tpu_torch.models.qmf import _channel_ranks
from lrf_tpu_torch.ops import bcd, color, pad, patch, resample, svd

import torch_images

PATHS = sorted(glob.glob(os.path.join(torch_images.DATA, "local7", "*.png")))
NAMES = [os.path.basename(p) for p in PATHS]
BOUNDS = (-16, 15)


def _stacks(img: np.ndarray, device: str = "cpu") -> list:
    """The codec's Y, Cb and Cr patch stacks `(1, M, 64)` of a photograph."""
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    return [patch.patchify(pad.pad_image(c, (8, 8)), (8, 8))[None].to(torch.float32)
            for c in resample.chroma_downsample(color.rgb_to_ycbcr(x), (0.5, 0.5))]


@pytest.fixture(scope="module")
def y_stacks():
    return [_stacks(torch_images.load(p))[0] for p in PATHS]


@pytest.mark.parametrize("name", NAMES)
def test_color_transform_equals_jax_bits(name):
    import jax.numpy as jnp

    from lrf_tpu.ops import color as jcolor

    rgb = torch_images.load(os.path.join(torch_images.DATA, "local7", name)).astype(np.float32)
    want = np.array(jcolor.rgb_to_ycbcr(jnp.asarray(rgb)))
    got = color.rgb_to_ycbcr(torch.from_numpy(rgb)).numpy()
    assert np.array_equal(got, want)
    noise = np.random.default_rng(len(name)).standard_normal(want.shape).astype(np.float32)
    for ycbcr in (want, want + 3 * noise):
        assert np.array_equal(color.ycbcr_to_rgb(torch.from_numpy(ycbcr)).numpy(),
                              np.asarray(jcolor.ycbcr_to_rgb(jnp.asarray(ycbcr))))


def test_exact_gram_is_the_rounded_float64_gram(y_stacks):
    for name, x in zip(NAMES, y_stacks):
        x64 = x.numpy().astype(np.float64)
        want = np.einsum("bmi,bmj->bij", x64, x64).astype(np.float32)
        assert np.array_equal(svd.exact_gram(x).numpy(), want), name


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_exact_gram_does_not_depend_on_row_shards(y_stacks, shards):
    for name, x in zip(NAMES, y_stacks):
        parts = torch.tensor_split(x, shards, dim=1)
        got = bcd.sum_shards([svd.gram64(p) for p in parts], x.device).to(torch.float32)
        assert torch.equal(got, svd.exact_gram(x)), name


def test_lapack_runs_on_one_blas_thread(y_stacks, monkeypatch):
    threads = svd._openblas_threads()
    if threads is None:
        pytest.skip("scipy here links no OpenBLAS of its own")
    before, seen = threads[0](), []
    batch = svd.lapack_batch.syevd_batch

    def counting(a, workers):
        seen.append((threads[0](), workers))
        return batch(a, workers)

    monkeypatch.setattr(svd.lapack_batch, "syevd_batch", counting)
    svd._lapack_eigh(svd.exact_gram(y_stacks[0]))
    assert seen == [(1, 0)] and threads[0]() == before


@pytest.mark.parametrize("what", ["eigh 64", "eigh 192", "svd"])
def test_host_lapack_loops_hold_the_lock(what, monkeypatch):
    # the gate's two modes: the eigh of a small Gram batch shares it on one
    # OpenBLAS thread (one native call for the batch); the eigh of larger
    # Grams and the SVD codec's ?gesdd hold it alone on the count found
    threads = svd._openblas_threads()
    if threads is None:
        pytest.skip("scipy here links no OpenBLAS of its own")
    before, seen = threads[0](), []
    name = what.split()[0]
    owner, attr = (svd.scipy.linalg, "svd") if name == "svd" else (svd.lapack_batch, "syevd_batch")
    call = getattr(owner, attr)

    def recording(*args, **kwargs):
        seen.append((svd._GATE.mode, threads[0]()))
        return call(*args, **kwargs)

    monkeypatch.setattr(owner, attr, recording)
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 192, 192)).astype(np.float32))
    if name == "svd":
        svd._lapack_svd(a)
        assert seen == [("many_threads", before)] * 2
    else:
        n = int(what.split()[1])
        svd._lapack_eigh(svd.exact_gram(a[..., :n]))
        one = n <= svd._ONE_THREAD_MAX_N
        assert seen == [("one_thread", 1) if one else ("many_threads", before)]
    assert threads[0]() == before and svd._GATE.mode is None


@pytest.mark.parametrize("method, m, n, want", [
    ("gram", 300, 64, ("gram", True)), ("gram", 16, 64, ("gram", True)),
    ("jacobi", 300, 64, ("jacobi", True)), ("randomized", 300, 64, ("randomized", False)),
    ("randomized", 64, 64, ("randomized", False)), ("randomized", 16, 64, ("gram", True)),
])
def test_gram_path(method, m, n, want, monkeypatch):
    assert svd.gram_path(method, m, n) == want
    seen, solvers = [], []
    eig = svd._gram_eig
    monkeypatch.setattr(svd, "left_factor", lambda x, s, v, exact=True: seen.append(exact) or x @ v)
    monkeypatch.setattr(bcd, "left_factor", svd.left_factor)
    monkeypatch.setattr(svd, "_gram_eig", lambda g, solver: solvers.append(solver) or eig(g, solver))
    x = torch.from_numpy(np.random.default_rng(m).random((1, m, n)).astype(np.float32))
    svd.truncated_svd(x, 4, method=method)
    bcd.sharded_svd_init([list(torch.tensor_split(x, 2, dim=1))], [4], BOUNDS, method)
    assert seen == [want[1]] * 3
    assert solvers == ([want[0]] * 2 if want[1] else [])


def test_gram_path_refuses_svd():
    with pytest.raises(ValueError):
        svd.gram_path("svd", 300, 64)


def test_gram_eig_is_lapack_eigh(y_stacks, monkeypatch):
    g = torch.cat([svd.exact_gram(x) for x in y_stacks])
    for got, want in zip(svd._gram_eig(g, "gram"), svd._lapack_eigh(g)):
        assert torch.equal(got, want)

    def refuse(*args, **kwargs):
        raise AssertionError("the exact init called torch.linalg.eigh")

    monkeypatch.setattr(torch.linalg, "eigh", refuse)
    bcd.svd_init(y_stacks[0], 6, bounds=BOUNDS)
    bcd.svd_init_shared(y_stacks[:2], [6, 6], bounds=BOUNDS)


def test_left_factor_does_not_depend_on_row_shards(y_stacks):
    for x in y_stacks:
        _, s, v = svd.truncated_svd(x, 13)
        whole = svd.left_factor(x, s, v)
        for shards in (2, 3):
            parts = [svd.left_factor(p, s, v) for p in torch.tensor_split(x, shards, dim=1)]
            assert torch.equal(torch.cat(parts, dim=1), whole)


def test_rounded_sqrt_and_division_are_the_cpus_float32_ops():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.random(1 << 16) * 2.0 ** rng.integers(-30, 40, 1 << 16)).astype(np.float32))
    assert np.array_equal(svd.rounded_sqrt(x).numpy(), np.sqrt(x.numpy()))
    a = torch.from_numpy(rng.standard_normal((4, 4096, 8)).astype(np.float32) * 1e3)
    s = torch.from_numpy(rng.random((4, 8)).astype(np.float32) * 1e4)
    v = torch.eye(8)
    assert torch.equal(svd.left_factor(a, s, v, exact=False), a / s[..., None, :])


@pytest.mark.parametrize("shards", [2, 3])
def test_patch_sharded_init_equals_unsharded(shards):
    for path in PATHS[:3]:
        y, cb, cr = _stacks(torch_images.load(path))
        stacks, ranks = [y, torch.cat([cb, cr])], [13, 6]
        want = bcd.svd_init_shared(stacks, ranks, bounds=BOUNDS)
        split = [list(torch.tensor_split(x, shards, dim=1)) for x in stacks]
        for (u, v, _), (us, vs) in zip(want, bcd.sharded_svd_init(split, ranks, BOUNDS)):
            assert torch.equal(torch.cat(us, dim=1), u) and torch.equal(vs, v), path


@pytest.mark.cuda
@pytest.mark.parametrize("quality", [10, 40])
@pytest.mark.parametrize("name", ["china.png", "clic_flower_fig.png"])
def test_card_init_equals_the_cpus(name, quality):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    img = torch_images.load(os.path.join(torch_images.DATA, "local7", name))
    size = tuple(img.shape[-2:])
    chroma = resample.scaled_size(size, (0.5, 0.5))
    ranks = _channel_ranks((size, chroma, chroma), None, quality, True, (8, 8))
    for card, cpu, r in zip(_stacks(img, "cuda"), _stacks(img), ranks):
        assert torch.equal(card.cpu(), cpu)
        for got, want in zip(bcd.svd_init(card, r, bounds=BOUNDS)[:2], bcd.svd_init(cpu, r, bounds=BOUNDS)[:2]):
            assert torch.equal(got.cpu(), want), (r, float((got.cpu() != want).float().mean()))
