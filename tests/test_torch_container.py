"""The port's byte container against the JAX package's.

The JAX package is called with `coder="zlib"`: where its native library is
built, its default "best" coder may emit libdeflate blobs, which the port
(zlib only) does not.
"""

import numpy as np
import pytest

from lrf_tpu.models import container as jc
from lrf_tpu_torch.models import container as tc

RNG = np.random.default_rng(7)


@pytest.fixture
def zlib_default():
    """Both packages' process-wide coder set to zlib, restored afterwards."""
    saved_j, saved_t = jc.get_fiber_coder(), tc.get_fiber_coder()
    jc.set_fiber_coder("zlib")
    tc.set_fiber_coder("zlib")
    yield
    jc.set_fiber_coder(*saved_j)
    tc.set_fiber_coder(*saved_t)


@pytest.mark.parametrize("shape", [(6144, 6), (96, 1), (64, 26), (1, 5)])
@pytest.mark.parametrize("mode", ["col", "row"])
def test_matrix_bytes_identical(shape, mode):
    m = RNG.integers(-16, 16, shape).astype(np.int8)
    got = tc.encode_matrix(m, mode=mode)
    assert got == jc.encode_matrix(m, mode=mode, coder="zlib")
    np.testing.assert_array_equal(tc.decode_matrix(got), m)
    np.testing.assert_array_equal(jc.decode_matrix(got), m)


@pytest.mark.parametrize("shape", [(1, 61, 7), (3, 40, 5), (2, 3, 4, 5)])
def test_tensor_bytes_identical(shape):
    t = RNG.integers(-16, 16, shape).astype(np.int8)
    got = tc.encode_tensor(t)
    assert got == jc.encode_tensor(t, coder="zlib")
    np.testing.assert_array_equal(tc.decode_tensor(got), t)
    np.testing.assert_array_equal(jc.decode_tensor(got), t)


def test_default_coders_give_zlib_bytes(zlib_default):
    m = RNG.integers(-16, 16, (300, 7)).astype(np.int8)
    want = jc.encode_matrix(m)
    for coder in (None, "zlib", "best", "deflate"):
        assert tc.encode_matrix(m, coder=coder) == want
    tc.set_fiber_coder("best")
    assert tc.encode_matrix(m) == want


def test_batch_coders_match_per_matrix():
    stack = RNG.integers(-16, 16, (4, 200, 6)).astype(np.int8)
    blobs = tc.encode_tensor_batch(stack)
    assert blobs == [jc.encode_matrix(s, coder="zlib") for s in stack]
    np.testing.assert_array_equal(tc.decode_matrix_batch(blobs), stack)
    np.testing.assert_array_equal(jc.decode_matrix_batch(blobs), stack)


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
