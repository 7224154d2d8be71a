"""The port's native fiber coder (`lrf_tpu_torch/native`).

Contracts:
- the library builds from the port's own source into `lrf_tpu_torch/_build/`,
  under a name keyed by the source and the command; a failed build raises
  with the compiler's output;
- "zlib" blobs equal CPython's `zlib.compress`; "deflate" (levels 6 and 12)
  and the "best" race equal the JAX package's native coder byte for byte;
- a build without libdeflate (what a host without `libdeflate.h` gets):
  "best" gives zlib-9 bytes, "deflate" raises naming the header, inflation
  still round-trips;
- `pack_values`, `assemble_streams`, `dpack_assemble_streams`,
  `dpack_encode` and `dpack_decode_segments` equal the JAX binding's output
  on the same buffers;
- concurrent calls from several threads give the single-threaded bytes.
"""

import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from lrf_tpu_torch.models import container as tc
from lrf_tpu_torch.native import fibercodec as tn
from lrf_tpu_torch.ops import entropy as te

RNG = np.random.default_rng(5)
ZLIB_ONLY = tn.NativeLib(("-DLRF_NO_LIBDEFLATE",))
SHAPES = [(6144, 6), (64, 3), (1, 5), (300, 1)]


@pytest.fixture(scope="module")
def jn():
    """The JAX package's binding of its own library (a different .so)."""
    from lrf_tpu.native import fibercodec

    if not fibercodec.available():
        pytest.skip("the JAX package's native fiber coder does not load here")
    return fibercodec


@pytest.fixture
def needs_deflate():
    if "deflate" not in tn.backends():
        pytest.skip("the port's native coder was built without libdeflate (no libdeflate.h here)")


def _matrix(shape, dtype=np.int8):
    smooth = np.cumsum(RNG.integers(-2, 3, shape), axis=0) % 32 - 16
    return smooth.astype(dtype)


def test_library_builds_into_build_dir():
    assert tn.backends()[0] == "zlib"
    path = tn.LIB.library_path()
    assert path.parent == tn.BUILD_DIR and path.parent.name == "_build" and path.exists()
    assert path.name.startswith("libfibercodec_") and path.suffix == ".so"
    assert ZLIB_ONLY.backends() == ("zlib",)
    assert ZLIB_ONLY.library_path() != path and ZLIB_ONLY.library_path().exists()
    assert "-DLRF_NO_LIBDEFLATE" in ZLIB_ONLY.command("x") and "-ldeflate" not in ZLIB_ONLY.command("x")


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path)
    broken = tn.NativeLib(("-include", "no_such_header_anywhere.h"))
    with pytest.raises(RuntimeError, match="no_such_header_anywhere"):
        broken.backends()
    assert list(tmp_path.iterdir()) == []  # no temporary or half-written library left


@pytest.mark.parametrize("lib", [tn.LIB, ZLIB_ONLY], ids=["full", "zlib_only"])
@pytest.mark.parametrize("mode", ["col", "row"])
@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
def test_zlib_equals_python_zlib(lib, mode, dtype):
    for shape in SHAPES:
        m = _matrix(shape, dtype)
        fibers = m.T if mode == "col" else m
        want = [zlib.compress(np.ascontiguousarray(f).tobytes(), 9) for f in fibers]
        assert tn.compress_fibers(m, mode, 9, "zlib", lib=lib) == want
        np.testing.assert_array_equal(tn.decompress_fibers(want, dtype, mode, lib=lib), m)


@pytest.mark.parametrize("level", [6, 12])
@pytest.mark.parametrize("mode", ["col", "row"])
def test_deflate_equals_jax(jn, needs_deflate, level, mode):
    for shape in SHAPES:
        m = _matrix(shape)
        blobs = tn.compress_fibers(m, mode, level, "deflate")
        assert blobs == jn.compress_fibers(m, mode, level, "deflate")
        np.testing.assert_array_equal(tn.decompress_fibers(blobs, np.int8, mode), m)
        assert [zlib.decompress(b) for b in blobs] == [np.ascontiguousarray(f).tobytes() for f in (m.T if mode == "col" else m)]


def test_best_race_equals_jax(jn, needs_deflate):
    from lrf_tpu.models import container as jc

    for shape in SHAPES:
        m = _matrix(shape)
        for mode in ("col", "row"):
            assert tc._compress_fibers(m, mode, 0, "best") == jc._compress_fibers(m, mode, 0, "best")


def test_build_without_libdeflate():
    m = _matrix((600, 4))
    with pytest.raises(RuntimeError, match="libdeflate.h"):
        tn.compress_fibers(m, "col", 6, "deflate", lib=ZLIB_ONLY)
    bufs = [m.reshape(1, 600, 4)]
    md = tc.dict_to_bytes({"x": 1})
    inner = [tc.dict_to_bytes({"num_fibers": 4, "mode": "col", "dtype": "int8"})]
    best = tn.assemble_streams(bufs, 1, [600], [4], md, inner, 0, "best", lib=ZLIB_ONLY)
    assert best == tn.assemble_streams(bufs, 1, [600], [4], md, inner, 9, "zlib", lib=ZLIB_ONLY)
    assert best == [tc.combine_bytes([md, tc.encode_matrix_plain(m)])]
    with pytest.raises(RuntimeError, match="libdeflate.h"):
        tn.assemble_streams(bufs, 1, [600], [4], md, inner, 6, "deflate", lib=ZLIB_ONLY)


@pytest.mark.parametrize("lib", [tn.LIB, ZLIB_ONLY], ids=["full", "zlib_only"])
def test_decompress_round_trips(lib):
    m = _matrix((777, 9))
    backends = ("zlib", "deflate") if "deflate" in tn.backends() else ("zlib",)
    for backend in backends:
        blobs = tn.compress_fibers(m, "col", 9 if backend == "zlib" else 12, backend)
        np.testing.assert_array_equal(tn.decompress_fibers(blobs, np.int8, "col", lib=lib), m)
        raw = tn.decompress_fibers_raw(blobs, np.int8, lib=lib)
        np.testing.assert_array_equal(raw, m.T)
    with pytest.raises(RuntimeError):  # a fiber of another size fails the exact-size check
        tn.decompress_fibers_raw([zlib.compress(b"\x01" * 10), zlib.compress(b"\x01" * 11)], np.int8, lib=lib)


def _factor_set(b=3):
    """Fiber-major (B * R, M) buffers and row-major (B, M, R) blocks of six
    codec-like factors."""
    shapes = [(b, 300, 7), (b, 64, 7), (b, 75, 3), (b, 64, 3), (b, 75, 3), (b, 64, 3)]
    blocks = [np.clip(np.cumsum(RNG.integers(-3, 4, s), axis=1), -16, 15).astype(np.int8) for s in shapes]
    fiber_major = [np.ascontiguousarray(f.transpose(0, 2, 1)).reshape(-1, f.shape[1]) for f in blocks]
    return shapes, blocks, fiber_major


def test_pack_values_equals_jax(jn):
    shapes, blocks, fm = _factor_set()
    ms, rs = [s[1] for s in shapes], [s[2] for s in shapes]
    got = tn.pack_values(fm, 3, ms, rs, -16, 5)
    np.testing.assert_array_equal(got, jn.pack_values(fm, 3, ms, rs, -16, 5))
    assert got.shape == (3, -(-sum(m * r for m, r in zip(ms, rs)) // 6))
    assert tn.pack_values(fm, 3, ms, rs, -8, 4) is None  # values outside [-8, 8)


@pytest.mark.parametrize("coder", ["zlib", "best", "deflate"])
def test_assemble_streams_equal_jax(jn, coder):
    if coder == "deflate" and "deflate" not in tn.backends():
        pytest.skip("the port's native coder was built without libdeflate (no libdeflate.h here)")
    shapes, blocks, _ = _factor_set()
    ms, rs = [s[1] for s in shapes], [s[2] for s in shapes]
    md = tc.dict_to_bytes({"rank": [7, 3, 3]})
    inner = [tc.dict_to_bytes({"num_fibers": r, "mode": "col", "dtype": "int8"}) for r in rs]
    level = {"zlib": 9, "best": 0, "deflate": 6}[coder]
    got = tn.assemble_streams(blocks, 3, ms, rs, md, inner, level, coder)
    assert got == jn.assemble_streams(blocks, 3, ms, rs, md, inner, level, coder)
    per_factor = [tc.encode_tensor_batch(f, coder=coder) for f in blocks]
    assert got == [tc.combine_bytes([md, tc.combine_bytes([p[i] for p in per_factor])]) for i in range(3)]
    # the fused entropy-transport assembler gives the same streams
    seg, main, exc = (t.numpy() for t in te.pack_segments([torch.from_numpy(f) for f in blocks]))
    used = exc.view(np.uint32)[: int(seg[-1]) * te.ROW_WORDS]
    args = (main.view(np.uint32), used, seg.astype(np.int64), 3, ms, rs, te.LENS, te.CODES, te.CHUNK,
            te.MAIN_WORDS, te.ROW_WORDS, md, inner, level, coder)
    dp = tn.dpack_assemble_streams(*args)
    assert dp == got == jn.dpack_assemble_streams(*args)


def test_dpack_encode_and_decode_equal_jax(jn):
    shapes, blocks, fm = _factor_set()
    ms, rs = [s[1] for s in shapes], [s[2] for s in shapes]
    tables = (te.LENS, te.CODES, te.CHUNK, te.MAIN_WORDS, te.ROW_WORDS)
    budget = te.default_exc_rows(te.segment_layout(shapes)[2][-1])
    got = tn.dpack_encode(fm, 3, ms, rs, *tables, budget)
    want = jn.dpack_encode(fm, 3, ms, rs, *tables, budget)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tn.dpack_encode(fm, 3, ms, rs, *tables, 1) is None  # over a 1-row budget
    # the device pack's buffers decode to the factor values, as the JAX binding decodes them
    seg, main, exc = (t.numpy() for t in te.pack_segments([torch.from_numpy(f) for f in blocks]))
    values, _, _ = te.segment_layout(shapes)
    dec_args = (main.view(np.uint32), exc.view(np.uint32), seg, values, te.segment_ranks(shapes), *tables)
    out = tn.dpack_decode_segments(*dec_args)
    np.testing.assert_array_equal(out, jn.dpack_decode_segments(*dec_args))
    np.testing.assert_array_equal(out, np.concatenate([f.reshape(-1) for f in blocks]))


def test_concurrent_calls_give_same_bytes():
    # Four threads (more than the pool's one submission slot) call the coder
    # and the assembler at once; every result must equal the serial one.
    shapes, blocks, _ = _factor_set(4)
    ms, rs = [s[1] for s in shapes], [s[2] for s in shapes]
    md = tc.dict_to_bytes({"k": 0})
    inner = [tc.dict_to_bytes({"num_fibers": r, "mode": "col", "dtype": "int8"}) for r in rs]
    m = _matrix((4000, 12))
    want_blobs = tn.compress_fibers(m, "col", 9, "zlib")
    want_streams = tn.assemble_streams(blocks, 4, ms, rs, md, inner, 0, "best")
    errors = []

    def work():
        try:
            for _ in range(10):
                assert tn.compress_fibers(m, "col", 9, "zlib") == want_blobs
                assert tn.assemble_streams(blocks, 4, ms, rs, md, inner, 0, "best") == want_streams
        except BaseException as exc:  # reported on the main thread below
            errors.append(exc)
            raise

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
