"""The exact init's host eigh: one native `?syevd` batch (`ops/svd.py::
_lapack_eigh`, `native/lapack_batch.py`) and the host LAPACK gate.

On the CPU:

- the native batch equals the scipy loop (`_lapack_eigh_plain`) bit for
  bit, eigenvalues and eigenvectors, on the exact Grams (`exact_gram`) of
  the seven `experiments/data/local7` photographs' Y stacks and merged
  Cb+Cr stacks (n = 64), and on seeded Grams of order 17, 128 and 512;
- it equals `jax.numpy.linalg.eigh` (jaxlib calls the same `?syevd`) bit
  for bit on the same inputs;
- its bits do not depend on the worker count: 1, 2 and 8 workers agree,
  each worker on a LAPACK instance of its own (scipy's OpenBLAS, or one of
  the private copies of it that load, up to one per CPU);
- two host threads that call `_lapack_eigh` at once get the serial bits,
  and their one-thread loops hold the gate at the same time; the OpenBLAS
  thread count is restored after; `_lapack_svd`, which holds the gate
  alone, never runs on a count of 1, and once it waits, new one-thread
  holders wait behind it;
- under stress (three holders per core, a switch interval of 1 us), no
  one-thread holder ever meets a lone holder or a count other than 1, and
  no lone holder meets another holder or a count other than the one found;
- a matrix that `?syevd` rejects (a NaN Gram: info > 0) raises, naming it.

About 10 s on one core of this host, most of it the n = 512 Grams and the
first build of the native library.
"""

import glob
import os
import sys
import threading

import numpy as np
import pytest
import torch

from lrf_tpu_torch.native import lapack_batch
from lrf_tpu_torch.ops import color, pad, patch, resample, svd

import torch_images

PATHS = sorted(glob.glob(os.path.join(torch_images.DATA, "local7", "*.png")))


def _grams_of(img: np.ndarray) -> list:
    """The exact Grams of a photograph's Y stack and merged Cb+Cr stack."""
    x = torch.from_numpy(np.ascontiguousarray(img))
    chans = resample.chroma_downsample(color.rgb_to_ycbcr(x), (0.5, 0.5))
    y, cb, cr = [patch.patchify(pad.pad_image(c, (8, 8)), (8, 8))[None].to(torch.float32) for c in chans]
    return [svd.exact_gram(y), svd.exact_gram(torch.cat([cb, cr]))]


@pytest.fixture(scope="module")
def local7_grams():
    return torch.cat([g for p in PATHS for g in _grams_of(torch_images.load(p))])


def _seeded(n: int, count: int) -> torch.Tensor:
    x = np.random.default_rng(1000 + n).standard_normal((count, 2 * n + 3, n)).astype(np.float32)
    return svd.exact_gram(torch.from_numpy(x))


CASES = {"local7": None, "n17": (17, 5), "n128": (128, 3), "n512": (512, 1)}


@pytest.fixture(scope="module", params=list(CASES))
def grams(request, local7_grams):
    spec = CASES[request.param]
    return local7_grams if spec is None else _seeded(*spec)


def _equal(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def test_native_batch_equals_scipy_loop(grams):
    got, want = svd._lapack_eigh(grams), svd._lapack_eigh_plain(grams)
    assert got[0].dtype == want[0].dtype == torch.float32 and got[1].shape == grams.shape
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_native_batch_equals_jax_eigh(grams):
    import jax.numpy as jnp

    w, v = jnp.linalg.eigh(jnp.asarray(grams.numpy()))
    assert _equal(svd._lapack_eigh(grams), (w, v))


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_bits_do_not_depend_on_the_worker_count(grams, threads):
    want = svd._lapack_eigh(grams)
    with svd._host_lapack(grams.shape[-1] <= svd._ONE_THREAD_MAX_N):
        assert _equal(lapack_batch.syevd_batch(grams.numpy(), threads), want)


def test_workers_get_instances_of_their_own():
    # scipy's OpenBLAS and private copies of it, up to one per CPU: workers
    # that shared one OpenBLAS would take turns on its buffer pool's mutex
    want = min(len(os.sched_getaffinity(0)), lapack_batch._MAX_INSTANCES)
    expect = want if svd._openblas_threads() is not None else 1
    assert lapack_batch.instances() == expect


def test_float64_takes_dsyevd():
    g = _seeded(24, 4).to(torch.float64)
    got = svd._lapack_eigh(g)
    assert got[0].dtype == torch.float64 and _equal(got, svd._lapack_eigh_plain(g))


def test_concurrent_callers_get_serial_bits(local7_grams, monkeypatch):
    threads = svd._openblas_threads()
    if threads is None:
        pytest.skip("scipy here links no OpenBLAS of its own")
    before = threads[0]()
    halves = (local7_grams[::2].contiguous(), local7_grams[1::2].contiguous())
    want = [svd._lapack_eigh(h) for h in halves]
    a = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 40, 30)).astype(np.float32))
    want_svd = svd._lapack_svd(a)
    counts = {"eigh": [], "svd": []}
    batch, scipy_svd = lapack_batch.syevd_batch, svd.scipy.linalg.svd

    def eigh_spy(*args):
        counts["eigh"].append(threads[0]())
        return batch(*args)

    def svd_spy(*args, **kwargs):
        counts["svd"].append(threads[0]())
        return scipy_svd(*args, **kwargs)

    monkeypatch.setattr(svd.lapack_batch, "syevd_batch", eigh_spy)
    monkeypatch.setattr(svd.scipy.linalg, "svd", svd_spy)
    got, bad = [[None] * 8, [None] * 8, [None] * 8], []

    def run(k: int) -> None:
        try:
            for i in range(8):
                got[k][i] = svd._lapack_svd(a) if k == 2 else svd._lapack_eigh(halves[k])
        except BaseException as e:
            bad.append(e)

    workers = [threading.Thread(target=run, args=(k,), daemon=True) for k in range(3)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(120)
    assert not any(t.is_alive() for t in workers) and not bad, bad
    assert all(_equal(r, want[k]) for k in range(2) for r in got[k])
    assert all(_equal(r, want_svd) for r in got[2])
    assert counts["eigh"] == [1] * 16 and counts["svd"] == [before] * 16
    assert threads[0]() == before and svd._GATE.mode is None


def _start(target) -> threading.Thread:
    t = threading.Thread(target=target, daemon=True)
    t.start()
    return t


def test_one_thread_holders_overlap():
    if svd._openblas_threads() is None:
        pytest.skip("scipy here links no OpenBLAS of its own")
    gate, inside, meet = svd._BlasGate(), threading.Barrier(2, timeout=20), []

    def hold() -> None:
        with gate.one_thread():
            meet.append(inside.wait())  # both must be inside at once

    workers = [_start(hold), _start(hold)]
    for t in workers:
        t.join(30)
    assert not any(t.is_alive() for t in workers)
    assert sorted(meet) == [0, 1] and gate.mode is None


def test_many_thread_holder_waits_and_is_not_starved():
    threads = svd._openblas_threads()
    if threads is None:
        pytest.skip("scipy here links no OpenBLAS of its own")
    before = threads[0]()
    gate, order = svd._BlasGate(), []
    first_in, release = threading.Event(), threading.Event()

    def sharer(name: str, hold: bool) -> None:
        with gate.one_thread():
            order.append((name, threads[0]()))
            if hold:
                first_in.set()
                release.wait(20)

    def alone() -> None:
        with gate.many_threads():
            order.append(("alone", threads[0]()))

    a = _start(lambda: sharer("first", True))
    assert first_in.wait(20)
    b = _start(alone)
    for _ in range(2000):  # until the many-thread holder is queued behind the first sharer
        if gate._waiting:
            break
        b.join(0.01)
    c = _start(lambda: sharer("late", False))
    c.join(0.3)
    assert order == [("first", 1)] and c.is_alive() and b.is_alive()
    release.set()
    for t in (a, b, c):
        t.join(20)
    assert not any(t.is_alive() for t in (a, b, c))
    assert order == [("first", 1), ("alone", before), ("late", 1)]
    assert threads[0]() == before and gate.mode is None


def test_gate_stress():
    # more holders than cores, switching often: every one-thread holder
    # sees a count of 1 and no lone holder, every lone holder sees the
    # count found and no one-thread holder
    threads = svd._openblas_threads()
    if threads is None:
        pytest.skip("scipy here links no OpenBLAS of its own")
    get, before = threads[0], threads[0]()
    gate, broken, lock = svd._BlasGate(), [], threading.Lock()
    inside = {"one": 0, "alone": 0}

    def enter(kind: str, delta: int) -> None:
        with lock:
            inside[kind] += delta
            other = inside["alone" if kind == "one" else "one"]
            if delta > 0 and (other or (kind == "alone" and inside["alone"] > 1)):
                broken.append(dict(inside))

    def worker(k: int) -> None:
        rng = np.random.default_rng(k)
        for _ in range(200):
            alone = rng.random() < 0.2
            with gate.many_threads() if alone else gate.one_thread():
                enter("alone" if alone else "one", 1)
                if get() != (before if alone else 1):
                    broken.append(("count", alone, get()))
                enter("alone" if alone else "one", -1)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [_start(lambda k=k: worker(k)) for k in range(3 * (os.cpu_count() or 4))]
        for t in workers:
            t.join(120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in workers)
    assert not broken, broken[:5]
    assert get() == before and gate.mode is None


def test_rejected_matrix_raises():
    g = _seeded(17, 4).numpy().copy()
    g[2, 5, 3] = np.nan
    with pytest.raises(np.linalg.LinAlgError, match="matrix 2 of 4"):
        svd._lapack_eigh(torch.from_numpy(g))
    with pytest.raises(TypeError):
        lapack_batch.syevd_batch(g.astype(np.float16))
