"""The port's byte container against the JAX package's.

Both packages run the same coder on the same matrix and must give the same
bytes: "zlib" always, "best" and "deflate" where the JAX package's native
library loads (without it, the JAX package gives zlib-9 bytes for them).
The port's "zlib" coder must also equal its own plain pure-Python version.
Where the native coder has no libdeflate, "deflate" codes with zlib-9 and
warns once, as the JAX package does without its library.
"""

import numpy as np
import pytest

import lrf_tpu_torch as lt

from lrf_tpu.models import container as jc
from lrf_tpu.native import fibercodec as jnative
from lrf_tpu_torch.models import container as tc
from lrf_tpu_torch.native import fibercodec as tnative

RNG = np.random.default_rng(7)


@pytest.fixture
def jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native fiber coder does not load here")


@pytest.fixture
def zlib_default():
    """Both packages' process-wide coder set to zlib, restored afterwards."""
    saved_j, saved_t = jc.get_fiber_coder(), tc.get_fiber_coder()
    jc.set_fiber_coder("zlib")
    tc.set_fiber_coder("zlib")
    yield
    jc.set_fiber_coder(*saved_j)
    tc.set_fiber_coder(*saved_t)


def _coders():
    return ("zlib", "best", "deflate") if "deflate" in tnative.backends() else ("zlib", "best")


@pytest.mark.parametrize("shape", [(6144, 6), (96, 1), (64, 26), (1, 5)])
@pytest.mark.parametrize("mode", ["col", "row"])
def test_matrix_bytes_identical(jax_native, shape, mode):
    m = RNG.integers(-16, 16, shape).astype(np.int8)
    for coder in _coders():
        got = tc.encode_matrix(m, mode=mode, coder=coder)
        assert got == jc.encode_matrix(m, mode=mode, coder=coder), coder
        np.testing.assert_array_equal(tc.decode_matrix(got), m)
        np.testing.assert_array_equal(jc.decode_matrix(got), m)
    assert tc.encode_matrix(m, mode=mode, coder="zlib") == tc.encode_matrix_plain(m, mode=mode)


@pytest.mark.parametrize("shape", [(1, 61, 7), (3, 40, 5), (2, 3, 4, 5)])
def test_tensor_bytes_identical(jax_native, shape):
    t = RNG.integers(-16, 16, shape).astype(np.int8)
    for coder in _coders():
        got = tc.encode_tensor(t, coder=coder)
        assert got == jc.encode_tensor(t, coder=coder), coder
        np.testing.assert_array_equal(tc.decode_tensor(got), t)
        np.testing.assert_array_equal(jc.decode_tensor(got), t)


def test_default_coders_give_zlib_bytes(jax_native, zlib_default):
    # With "zlib" as the process default, the default coder gives zlib-9
    # bytes; the named coders give their own, the JAX package's bytes.
    m = RNG.integers(-16, 16, (300, 7)).astype(np.int8)
    want = jc.encode_matrix(m)
    assert tc.encode_matrix(m) == tc.encode_matrix(m, coder="zlib") == want
    assert want == tc.encode_matrix_plain(m)
    for coder in _coders():
        assert tc.encode_matrix(m, coder=coder) == jc.encode_matrix(m, coder=coder)
    tc.set_fiber_coder("best")
    assert tc.get_fiber_coder() == ("best", 0)
    assert tc.encode_matrix(m) == jc.encode_matrix(m, coder="best")


def test_batch_coders_match_per_matrix(jax_native):
    stack = RNG.integers(-16, 16, (4, 200, 6)).astype(np.int8)
    for coder in _coders():
        blobs = tc.encode_tensor_batch(stack, coder=coder)
        assert blobs == [tc.encode_matrix(s, coder=coder) for s in stack]
        assert blobs == [jc.encode_matrix(s, coder=coder) for s in stack]
        np.testing.assert_array_equal(tc.decode_matrix_batch(blobs), stack)
        np.testing.assert_array_equal(jc.decode_matrix_batch(blobs), stack)
    rows = tc.encode_matrix_batch(stack, mode="row")
    assert rows == [jc.encode_matrix(s, mode="row") for s in stack]
    np.testing.assert_array_equal(tc.decode_matrix_batch(rows), stack)
    with pytest.raises(ValueError):
        tc.decode_matrix_batch([tc.encode_matrix(stack[0]), tc.encode_matrix(stack[0, :, :3])])


def test_framing_and_metadata():
    payloads = [b"abc", b"", b"\x00" * 300, b"xyz"]
    combined = tc.combine_bytes(payloads)
    assert combined == jc.combine_bytes(payloads)
    assert tc.separate_bytes(combined, 4) == tuple(payloads)
    d = {"dtype": "uint8", "rank": [6, 3, 3], "bounds": [-16, 15]}
    assert tc.dict_to_bytes(d) == jc.dict_to_bytes(d)
    assert tc.bytes_to_dict(tc.dict_to_bytes(d)) == d
    with pytest.raises(ValueError):
        tc.set_fiber_coder("lz4")


def test_deflate_without_libdeflate_falls_back_to_zlib(monkeypatch):
    # The card's machine has no libdeflate.h: its build is this flavour.
    import lrf_tpu
    from torch_images import photos

    monkeypatch.setattr(tnative, "LIB", tnative.NativeLib(("-DLRF_NO_LIBDEFLATE",)))
    monkeypatch.setattr(tnative, "_WARNED_NO_LIBDEFLATE", False)
    saved = tc.get_fiber_coder()
    images = photos(2, 48, 64, seed=9)
    try:
        tc.set_fiber_coder("zlib")
        want = lt.sharded_qmf_encode_batch(images, device="cpu", quality=10)
        tc.set_fiber_coder("deflate")
        with pytest.warns(RuntimeWarning, match="libdeflate.h") as seen:
            got = lt.sharded_qmf_encode_batch(images, device="cpu", quality=10)
            single = lt.qmf_encode(images[0], device="cpu", quality=10)
            blob = tc.encode_matrix(images[0, 0], coder="deflate")
        assert tc.get_fiber_coder() == ("deflate", 6)  # what was asked for
    finally:
        tc.set_fiber_coder(*saved)
    assert len(seen) == 1  # once per process
    assert tnative.backends() == ("zlib",)
    assert got == want and single == want[0]
    assert blob == tc.encode_matrix(images[0, 0], coder="zlib")
    for stream in got:
        np.testing.assert_array_equal(np.asarray(lrf_tpu.qmf_decode(stream)), lt.qmf_decode(stream, device="cpu"))
