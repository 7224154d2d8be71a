"""AddressSanitizer pass over every entry point of the port's native coder.

    python -m lrf_tpu_torch.native.asan_check [full] [zlib-only]

`fibercodec.cpp` is built with `-O1 -g -fsanitize=address` in two flavours:
"full" (with libdeflate, where `g++` finds `libdeflate.h`) and "zlib-only"
(`-DLRF_NO_LIBDEFLATE`, the build of a host without libdeflate). The flags
enter the library's hash, so the instrumented builds sit beside the normal
one in `_build/` and never replace it. Every exported function runs,
adversarial and error cases included: odd and degenerate shapes, corrupted
and truncated blobs, the pack's out-of-bounds guard, the entropy coder's
row budget and alphabet guards, a truncated continuation stream and a bad
Huffman table. Where the JAX package's binding returns None, the port's
raises, and the check asserts the raise.

The instrumented library loads only into a process whose first library is
the ASan runtime. Without it, this command runs each flavour in a child
process under `LD_PRELOAD=$(g++ -print-file-name=libasan.so)` and
`ASAN_OPTIONS=detect_leaks=0` (300 s each) and exits non-zero when a child
fails or ASan reports. A heap overflow in the JAX package's copy of this
coder once shipped unnoticed, so every change to `fibercodec.cpp` gets
this pass.
"""

from __future__ import annotations

import os
import subprocess
import sys
import warnings
import zlib

import numpy as np

from lrf_tpu_torch.native import fibercodec as m
from lrf_tpu_torch.ops import entropy as E

ASAN_FLAGS = ("-O1", "-g", "-fno-omit-frame-pointer", "-fsanitize=address")
FLAVOURS = {"full": (), "zlib-only": ("-DLRF_NO_LIBDEFLATE",)}
CHILD_TIMEOUT_S = 300


def asan_lib(flavour: str) -> m.NativeLib:
    """The instrumented library of one flavour."""
    return m.NativeLib(ASAN_FLAGS + FLAVOURS[flavour])


def asan_runtime() -> str | None:
    """Path of g++'s shared ASan runtime, or None when it has none."""
    path = subprocess.run(
        [m._find_cxx(), "-print-file-name=libasan.so"], capture_output=True, text=True, timeout=60
    ).stdout.strip()
    return path if os.path.isabs(path) and os.path.exists(path) else None


def asan_env() -> dict:
    """This process's environment with the ASan runtime preloaded."""
    runtime = asan_runtime()
    if runtime is None:
        raise RuntimeError("g++ has no shared ASan runtime (g++ -print-file-name=libasan.so finds none)")
    return {**os.environ, "LD_PRELOAD": runtime, "ASAN_OPTIONS": "detect_leaks=0"}


def _raises(exc, fn) -> None:
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"expected {exc.__name__}")


def _smooth(rng, shape) -> np.ndarray:
    return np.clip(np.cumsum(rng.integers(-2, 3, shape), axis=-1), -16, 15).astype(np.int8)


def _inner(rs) -> list[bytes]:
    from lrf_tpu_torch.models.container import dict_to_bytes

    return [dict_to_bytes({"num_fibers": int(r), "mode": "col", "dtype": "int8"}) for r in rs]


def check(lib: m.NativeLib) -> None:
    """Run every entry point of `lib` on ordinary, degenerate and hostile
    inputs; raises AssertionError on a wrong result."""
    rng = np.random.default_rng(0)
    deflate = "deflate" in lib.backends()
    print(f"backends {lib.backends()}; library {lib.library_path().name}", flush=True)

    # 1. compress / decompress round trips, then corrupted and truncated blobs
    for n, mm in [(1, 1), (3, 7), (64, 1536), (31, 999)]:
        mat = rng.integers(-16, 16, (n, mm)).astype(np.int8)
        for backend, lvl in [("zlib", 9), ("deflate", 1), ("deflate", 12)]:
            blobs = m.compress_fibers(mat, "row", lvl, backend, lib=lib)
            np.testing.assert_array_equal(m.decompress_fibers(blobs, np.int8, "row", lib=lib), mat)
            np.testing.assert_array_equal(m.decompress_fibers(m.compress_fibers(mat.T, "col", lvl, backend, lib=lib),
                                                              np.int8, "col", lib=lib), mat.T)
    mat = rng.integers(-16, 16, (2, 500)).astype(np.int8)
    good = m.compress_fibers(mat, "row", 9, "zlib", lib=lib)
    for bad in (good[1][:-6], good[1][:8], good[1][:4] + bytes(len(good[1]) - 4)):
        _raises(RuntimeError, lambda bad=bad: m.decompress_fibers_raw([good[0], bad], np.int8, lib=lib))
    # bytes after a complete stream are not read
    np.testing.assert_array_equal(m.decompress_fibers_raw([good[0], good[1] + b"\xff" * 16], np.int8, lib=lib), mat)
    print("compress/decompress ok (incl. corrupted and truncated blobs)", flush=True)

    # 2. pack_values, its out-of-bounds guard and degenerate shapes
    for shapes in [[(2, 7, 3)], [(4, 300, 6), (4, 77, 3)], [(1, 1, 1)]]:
        b = shapes[0][0]
        raws = [rng.integers(-16, 16, (b * r, mm)).astype(np.int8) for (_, mm, r) in shapes]
        packed = m.pack_values(raws, b, [mm for _, mm, _ in shapes], [r for *_, r in shapes], -16, 5, lib=lib)
        assert packed is not None
    assert m.pack_values([np.full((4, 5), 100, np.int8)], 2, [5], [2], -16, 5, lib=lib) is None
    print("pack_values ok (incl. the out-of-bounds guard)", flush=True)

    # 3. dpack_encode: smooth, extreme deltas, budget overflow, out-of-alphabet
    for shapes, kind in [([(2, 300, 6)], "smooth"), ([(2, 100, 4)], "noise"), ([(1, 1, 1)], "smooth"),
                         ([(3, 65, 2), (3, 64, 1)], "noise")]:
        b = shapes[0][0]
        raws = [_smooth(rng, (b * r, mm)) if kind == "smooth"
                else np.where(rng.random((b * r, mm)) < 0.5, -16, 15).astype(np.int8) for (_, mm, r) in shapes]
        budget = E.MAX_ROWS * sum(b * (-(-mm * r // E.CHUNK)) for _, mm, r in shapes) + 8
        main, exc, cr, _ = m.dpack_encode(raws, b, [mm for _, mm, _ in shapes], [r for *_, r in shapes], E.LENS,
                                          E.CODES, E.CHUNK, E.MAIN_WORDS, E.ROW_WORDS, budget, lib=lib)
        bases = np.concatenate([[0], np.cumsum(cr)])
        vals, _, bounds = E.segment_layout(shapes)
        dec = E.decode_segments_py(main, exc, bases[np.asarray(bounds)], vals, E.segment_ranks(shapes))
        expect = np.concatenate([np.ascontiguousarray(raw.reshape(b, r, mm).transpose(0, 2, 1)).reshape(-1)
                                 for raw, (_, mm, r) in zip(raws, shapes)]).astype(np.int32)
        np.testing.assert_array_equal(dec, expect)
    noisy = [np.where(rng.random((4, 200)) < 0.5, -16, 15).astype(np.int8)]
    assert m.dpack_encode(noisy, 2, [200], [2], E.LENS, E.CODES, E.CHUNK, E.MAIN_WORDS, E.ROW_WORDS, 1,
                          lib=lib) is None  # over the row budget
    wild = [np.asarray([[-100, 100] * 50] * 4, np.int8)]
    assert m.dpack_encode(wild, 2, [100], [2], E.LENS, E.CODES, E.CHUNK, E.MAIN_WORDS, E.ROW_WORDS, 100000,
                          lib=lib) is None  # deltas outside the alphabet
    print("dpack_encode ok (incl. the budget and alphabet guards)", flush=True)

    # 4. the native segment decoder on the encoder's output
    shapes, b, ms, rs = [(2, 300, 6), (2, 64, 1)], 2, [300, 64], [6, 1]
    raws = [_smooth(rng, (b * r, mm)) for mm, r in zip(ms, rs)]
    budget = E.default_exc_rows(sum(b * (-(-mm * r // E.CHUNK)) for mm, r in zip(ms, rs)))
    main, exc, cr, nr = m.dpack_encode(raws, b, ms, rs, E.LENS, E.CODES, E.CHUNK, E.MAIN_WORDS, E.ROW_WORDS, budget,
                                       lib=lib)
    bases = np.concatenate([[0], np.cumsum(cr)])
    vals, _, bounds = E.segment_layout(shapes)
    seg_base = bases[np.asarray(bounds)].astype(np.int64)
    flat = m.dpack_decode_segments(main, exc, seg_base, vals, E.segment_ranks(shapes), E.LENS, E.CODES, E.CHUNK,
                                   E.MAIN_WORDS, E.ROW_WORDS, lib=lib)
    expect = np.concatenate([np.ascontiguousarray(raw.reshape(b, r, mm).transpose(0, 2, 1)).reshape(-1)
                             for raw, mm, r in zip(raws, ms, rs)])
    np.testing.assert_array_equal(flat, expect)
    m.dpack_decode_segments(main, exc[:0], seg_base, vals, E.segment_ranks(shapes), E.LENS, E.CODES, E.CHUNK,
                            E.MAIN_WORDS, E.ROW_WORDS, lib=lib)  # truncated exc reads as zeros, in bounds
    print("dpack_decode_segments ok (incl. truncated exc)", flush=True)

    # 5. the fused stream assemblers, across backends and degenerate shapes
    md = b'{"k": 1}'
    for fshapes in [[(2, 300, 6), (2, 16, 1)], [(1, 1, 1)], [(3, 64, 5)]]:
        fb = fshapes[0][0]
        fms, frs = [s[1] for s in fshapes], [s[2] for s in fshapes]
        for factors in ([_smooth(rng, s) for s in fshapes], [rng.integers(-16, 16, s).astype(np.int8) for s in fshapes]):
            zlib_streams = m.assemble_streams(factors, fb, fms, frs, md, _inner(frs), 9, "zlib", lib=lib)
            assert len(zlib_streams) == fb
            # the same fibers coded elsewhere, framed from per-factor slots
            caps = [m.fiber_cap(mm) for mm in fms]
            blobs = [zlib.compress(np.ascontiguousarray(f[i, :, r]).tobytes(), 9)
                     for f in factors for i in range(fb) for r in range(f.shape[2])]
            slot_caps = [c for f, c in zip(factors, caps) for _ in range(fb * f.shape[2])]
            slots = np.frombuffer(b"".join(x + bytes(c - len(x)) for x, c in zip(blobs, slot_caps)), np.uint8)
            lens = np.array([len(x) for x in blobs], np.int32)
            assert m.frame_streams(slots, lens, fb, frs, caps, md, _inner(frs), lib=lib) == zlib_streams
            lens[-1] = slot_caps[-1] + 1
            _raises(RuntimeError, lambda: m.frame_streams(slots, lens, fb, frs, caps, md, _inner(frs), lib=lib))
            for backend, lvl in [("deflate", 1), ("best", 0)]:
                streams = m.assemble_streams(factors, fb, fms, frs, md, _inner(frs), lvl, backend, lib=lib)
                assert len(streams) == fb and (deflate or streams == zlib_streams)
    factors = [np.ascontiguousarray(raw.reshape(b, r, mm).transpose(0, 2, 1)) for raw, mm, r in zip(raws, ms, rs)]
    md = b'{"k": 2}'
    for backend, lvl in [("zlib", 9), ("deflate", 1)]:
        got = m.dpack_assemble_streams(main, exc[: nr * E.ROW_WORDS], seg_base, b, ms, rs, E.LENS, E.CODES, E.CHUNK,
                                       E.MAIN_WORDS, E.ROW_WORDS, md, _inner(rs), lvl, backend, lib=lib)
        assert got == m.assemble_streams(factors, b, ms, rs, md, _inner(rs), lvl, backend, lib=lib), backend
    got = m.dpack_assemble_streams(main, exc[:0], seg_base, b, ms, rs, E.LENS, E.CODES, E.CHUNK, E.MAIN_WORDS,
                                   E.ROW_WORDS, md, _inner(rs), 1, "deflate", lib=lib)
    assert len(got) == b  # truncated exc: rows past the stream read as zeros
    bad_lens = np.array(E.LENS, np.int32).copy()
    bad_lens[0] = 0
    _raises(RuntimeError, lambda: m.dpack_assemble_streams(
        main, exc, seg_base, b, ms, rs, bad_lens, E.CODES, E.CHUNK, E.MAIN_WORDS, E.ROW_WORDS, md, _inner(rs), 1,
        "deflate", lib=lib))
    print("assemble_streams, frame_streams and dpack_assemble_streams ok (incl. truncated exc and a bad Huffman "
          "table)", flush=True)


def _preloaded() -> bool:
    return "libasan" in os.environ.get("LD_PRELOAD", "")


def main(argv: list[str]) -> int:
    flavours = argv or list(FLAVOURS)
    unknown = [f for f in flavours if f not in FLAVOURS]
    if unknown:
        print(f"unknown flavour {unknown}; one of {list(FLAVOURS)}", file=sys.stderr)
        return 2
    if not _preloaded():
        env = asan_env()
        worst = 0
        for flavour in flavours:
            proc = subprocess.run([sys.executable, "-m", "lrf_tpu_torch.native.asan_check", flavour], env=env,
                                  timeout=CHILD_TIMEOUT_S)
            worst = worst or proc.returncode
        return worst
    for flavour in flavours:
        lib = asan_lib(flavour)
        print(f"== flavour {flavour}: {' '.join(lib.command('OUT'))}", flush=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "deflate" in a zlib-only build warns; it is exercised on purpose
            check(lib)
    print("ALL ASAN CHECKS PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
