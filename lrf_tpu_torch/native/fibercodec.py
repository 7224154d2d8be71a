"""ctypes binding of the port's native fiber codec (`fibercodec.cpp`).

Port of `lrf_tpu/native/fibercodec.py:70-616` over the port's own copy of
the C++ source. The library is compiled with g++ at first use into the
gitignored `lrf_tpu_torch/_build/` (`-O3 -std=c++17 -fPIC -shared`, then
`-lz -lpthread`, plus `-ldeflate` when the compiler finds `libdeflate.h`),
under a file name keyed by a hash of the source and the command. The
build writes a temporary file and renames it into place, so processes
that build at the same moment never load a half-written library.

Unlike the JAX package, nothing here falls back to pure-Python zlib: a
failed build raises with the compiler's output. Asking for the libdeflate
backend in a build without it codes with zlib at level 9, as the JAX
package does without its library, and warns once per process, naming the
header. Every function takes the library as `lib`; None means the
process's `LIB`, read at call time.
Every call releases the GIL (ctypes does), so serializer threads overlap.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
import warnings
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fibercodec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
NO_BACKEND = -100  # fibercodec.cpp's kNoBackend
_BACKENDS = {"zlib": 0, "deflate": 1, "best": 2}

_P, _I, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int32, ctypes.c_int64
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PU32 = ctypes.POINTER(ctypes.c_uint32)
_PU8 = ctypes.POINTER(ctypes.c_uint8)
_PI8 = ctypes.POINTER(ctypes.c_int8)

# name -> (restype, argtypes) of every exported entry point
_SIGNATURES = {
    "lrf_backends": (_I, []),
    "lrf_compress_fibers2": (_I, [_P, _I64, _I64, _I, _I, _PU8, _I64, _PI64]),
    "lrf_decompress_fibers": (_I, [ctypes.c_char_p, _PI64, _I64, _PU8, _I64]),
    "lrf_dpack_decode_segments": (
        _I, [_P, _P, _I64, _PI64, _PI64, _PI64, _I64, _PI32, _PU32, _I64, _I64, _I64, _I64, _I64, _PI8],
    ),
    "lrf_pack_values": (_I, [ctypes.POINTER(_P), _I64, _I64, _PI64, _PI64, _I32, _I32, _I64, _PU32]),
    "lrf_assemble_streams": (
        _I,
        [ctypes.POINTER(_P), _I64, _I64, _PI64, _PI64, _I64, ctypes.c_char_p, _I64, ctypes.c_char_p, _PI64,
         _I, _I, _PU8, _I64, _PI64],
    ),
    "lrf_frame_streams": (
        _I, [_P, _PI32, _I64, _I64, _PI64, _PI64, ctypes.c_char_p, _I64, ctypes.c_char_p, _PI64, _PU8, _I64, _PI64],
    ),
    "lrf_dpack_assemble_streams": (
        _I,
        [_P, _P, _I64, _PI64, _I64, _I64, _PI64, _PI64, _I64, _PI32, _PU32, _I64, _I64, _I64, _I64, _I64,
         ctypes.c_char_p, _I64, ctypes.c_char_p, _PI64, _I, _I, _PU8, _I64, _PI64],
    ),
    "lrf_dpack_encode": (
        _I,
        [ctypes.POINTER(_P), _I64, _I64, _PI64, _PI64, _PI32, _PU32, _I64, _I64, _I64, _I64, _I64, _PU32, _PU32,
         _PU8, _PI64],
    ),
}


def _find_cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the port's native libraries need g++ on PATH to build")
    return cxx


def _has_header(cxx: str, header: str) -> bool:
    """Whether `cxx` finds `header` on its include path."""
    proc = subprocess.run(
        [cxx, "-x", "c++", "-E", "-o", os.devnull, "-"],
        input=f"#include <{header}>\n", capture_output=True, text=True, timeout=60,
    )
    return proc.returncode == 0


class GxxLib:
    """A C++ source of this folder compiled with g++ at first use into
    `_build/<stem>_<hash of source and command>.so` and loaded through
    ctypes with `signatures` (name -> (restype, argtypes)).

    `defines` are extra compiler flags. Subclasses name the source, the
    stem, the signatures and the libraries to link (`link_libs`), and the
    `headers` the source includes (hashed with it).
    """

    source: Path
    stem: str
    signatures: dict
    headers: tuple = ()

    def __init__(self, defines: tuple[str, ...] = ()):
        self.defines = tuple(defines)
        self.build_seconds: Optional[float] = None  # set when this object compiled the library
        self._lib = None
        self._path: Optional[Path] = None
        self._lock = threading.Lock()

    def link_libs(self, cxx: str) -> list[str]:
        return ["-lpthread"]

    def command(self, out: str) -> list[str]:
        cxx = _find_cxx()
        return [cxx, *CXX_FLAGS, *self.defines, "-o", out, str(self.source), *self.link_libs(cxx)]

    def library_path(self) -> Path:
        """`_build/<stem>_<hash of source and command>.so`."""
        if self._path is None:
            h = hashlib.sha256(" ".join(self.command("OUT")).encode() + b"\0")
            h.update(self.source.read_bytes())
            for header in self.headers:
                h.update(header.read_bytes())
            self._path = BUILD_DIR / f"{self.stem}_{h.hexdigest()[:16]}.so"
        return self._path

    def build(self) -> Path:
        path = self.library_path()
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(self.command(tmp), capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {self.source.name} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_seconds = time.perf_counter() - t0
        return path

    def lib(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, (restype, argtypes) in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                self._lib = lib
            return self._lib


class NativeLib(GxxLib):
    """The compiled coder library, built and loaded on first use.

    `-DLRF_NO_LIBDEFLATE` in `defines` builds the zlib-only library even
    where libdeflate is installed (the build a host without `libdeflate.h`
    gets), so both builds can be tested on one host.
    """

    source = SOURCE
    stem = "libfibercodec"
    signatures = _SIGNATURES

    def link_libs(self, cxx: str) -> list[str]:
        libs = ["-lz", "-lpthread"]
        if "-DLRF_NO_LIBDEFLATE" not in self.defines and _has_header(cxx, "libdeflate.h"):
            libs.append("-ldeflate")
        return libs

    def backends(self) -> tuple[str, ...]:
        """The compressor backends compiled in: ("zlib",) or ("zlib", "deflate")."""
        mask = self.lib().lrf_backends()
        return ("zlib", "deflate") if mask & 2 else ("zlib",)


LIB = NativeLib()


def backends() -> tuple[str, ...]:
    return LIB.backends()


_WARNED_NO_LIBDEFLATE = False


def _backend(backend: str, level: int, lib: Optional[NativeLib]) -> tuple[int, int]:
    """`(backend id, level)` the library runs for `backend` at `level`.

    "deflate" in a build without libdeflate runs zlib at level 9, as the
    JAX package does without its native library, and warns once per
    process, naming the missing header.
    """
    global _WARNED_NO_LIBDEFLATE
    if backend not in _BACKENDS:
        raise ValueError(f"unknown coder backend {backend!r}; one of {tuple(_BACKENDS)}")
    if backend == "deflate" and "deflate" not in (lib or LIB).backends():
        if not _WARNED_NO_LIBDEFLATE:
            _WARNED_NO_LIBDEFLATE = True
            warnings.warn(
                "coder backend 'deflate' needs libdeflate, and the native fiber coder was built without it "
                "(libdeflate.h was not found at build time): coding with zlib at level 9 instead",
                RuntimeWarning, stacklevel=3,
            )
        return _BACKENDS["zlib"], 9
    return _BACKENDS[backend], level


def _check(rc: int, what: str) -> None:
    if rc == NO_BACKEND:
        raise RuntimeError(f"{what}: libdeflate was not compiled in (libdeflate.h was not found at build time)")
    if rc != 0:
        raise RuntimeError(f"{what} failed with code {rc}")


def _ptrs(bufs: Sequence[np.ndarray]):
    return (ctypes.c_void_p * len(bufs))(*[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs])


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def compress_fibers(
    matrix: np.ndarray, mode: str, level: int = 9, backend: str = "zlib", lib: Optional[NativeLib] = None
) -> list[bytes]:
    """DEFLATE each fiber (column for "col", row for "row") of a 2-D array.

    "zlib" gives the bytes of CPython's `zlib.compress(fiber, level)`;
    "deflate" uses libdeflate (zlib-9, with a warning, where it was not
    compiled in).
    """
    backend_id, level = _backend(backend, level, lib)
    if backend_id == 2:
        raise ValueError("compress_fibers takes 'zlib' or 'deflate'; the 'best' race is container._compress_fibers")
    fibers = np.ascontiguousarray(matrix.T if mode == "col" else matrix)
    num_fibers = fibers.shape[0]
    if num_fibers == 0:
        return []
    fiber_bytes = fibers.shape[1] * fibers.dtype.itemsize
    cap = fiber_bytes + fiber_bytes // 1000 + 64  # zlib's compressBound, with room
    out = np.empty(num_fibers * cap, dtype=np.uint8)
    out_lens = np.empty(num_fibers, dtype=np.int64)
    rc = (lib or LIB).lib().lrf_compress_fibers2(
        fibers.ctypes.data_as(ctypes.c_void_p), num_fibers, fiber_bytes, level, backend_id,
        _ptr(out, ctypes.c_uint8), cap, _ptr(out_lens, ctypes.c_int64),
    )
    _check(rc, "compress_fibers")
    return [out[i * cap : i * cap + out_lens[i]].tobytes() for i in range(num_fibers)]


def decompress_fibers_raw(blobs: Sequence[bytes], dtype, lib: Optional[NativeLib] = None) -> np.ndarray:
    """Inflate fibers to the raw fiber-major `(num_fibers, per)` array, with
    no transpose (what `pack_values` reads). Every fiber must inflate to the
    size of the first one."""
    dtype = np.dtype(dtype)
    if len(blobs) == 0:
        raise ValueError("no fibers to inflate")
    blob_lens = np.asarray([len(b) for b in blobs], dtype=np.int64)
    fiber_bytes = len(zlib.decompress(blobs[0]))  # the fiber size is in no header
    out = np.empty(len(blobs) * fiber_bytes, dtype=np.uint8)
    rc = (lib or LIB).lib().lrf_decompress_fibers(
        b"".join(blobs), _ptr(blob_lens, ctypes.c_int64), len(blobs), _ptr(out, ctypes.c_uint8), fiber_bytes
    )
    _check(rc, "decompress_fibers")
    return out.view(dtype).reshape(len(blobs), -1)


def decompress_fibers(blobs: Sequence[bytes], dtype, mode: str, lib: Optional[NativeLib] = None) -> np.ndarray:
    """Inverse of `compress_fibers`: the 2-D array."""
    fibers = decompress_fibers_raw(blobs, dtype, lib)
    return fibers.T.copy() if mode == "col" else fibers


def dpack_decode_segments(
    main: np.ndarray,
    exc: np.ndarray,
    seg_row_base: np.ndarray,
    seg_values: Sequence[int],
    seg_ranks: Sequence[int],
    lens: np.ndarray,
    codes: np.ndarray,
    chunk: int,
    main_words: int,
    row_words: int,
    lib: Optional[NativeLib] = None,
) -> np.ndarray:
    """Decode the delta+Huffman transport (`ops/entropy.py::pack_segments`)
    straight to int8 factor values, segments concatenated."""
    main_b = np.ascontiguousarray(main).view(np.uint8).reshape(-1)
    exc_b = np.ascontiguousarray(exc).view(np.uint8).reshape(-1)
    seg_base = _i64(seg_row_base)
    values = _i64(seg_values)
    ranks = _i64(seg_ranks)
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    codes32 = np.ascontiguousarray(codes, dtype=np.uint32)
    out = np.empty(int(values.sum()), np.int8)
    rc = (lib or LIB).lib().lrf_dpack_decode_segments(
        main_b.ctypes.data_as(ctypes.c_void_p), exc_b.ctypes.data_as(ctypes.c_void_p), exc_b.size // (row_words * 4),
        _ptr(seg_base, ctypes.c_int64), _ptr(values, ctypes.c_int64), _ptr(ranks, ctypes.c_int64), len(values),
        _ptr(lens32, ctypes.c_int32), _ptr(codes32, ctypes.c_uint32), len(lens32), chunk, main_words, row_words,
        int(lens32.max()), _ptr(out, ctypes.c_int8),
    )
    _check(rc, "dpack_decode_segments")
    return out


def pack_values(
    factor_bufs: Sequence[np.ndarray], b: int, ms: Sequence[int], rs: Sequence[int], lo: int, bits: int,
    lib: Optional[NativeLib] = None,
) -> Optional[np.ndarray]:
    """Bit-pack fiber-major int8 factor buffers (factor k: `(B * R_k, M_k)`)
    into the decode upload's `(B, words)` uint32 layout, `30 // bits` values
    per word. None when a value falls outside `[lo, lo + 2^bits)`: the
    caller then uploads unpacked."""
    vals_per_word = 30 // bits
    words = -(-sum(int(m) * int(r) for m, r in zip(ms, rs)) // vals_per_word)
    out = np.empty((b, words), dtype=np.uint32)
    bufs = [np.ascontiguousarray(f, dtype=np.int8) for f in factor_bufs]
    ms_a, rs_a = _i64(ms), _i64(rs)
    rc = (lib or LIB).lib().lrf_pack_values(
        _ptrs(bufs), len(bufs), b, _ptr(ms_a, ctypes.c_int64), _ptr(rs_a, ctypes.c_int64), lo, bits, words,
        _ptr(out, ctypes.c_uint32),
    )
    return None if rc != 0 else out


def dpack_encode(
    factor_bufs: Sequence[np.ndarray], b: int, ms: Sequence[int], rs: Sequence[int], lens: np.ndarray,
    codes: np.ndarray, chunk: int, main_words: int, row_words: int, max_rows_budget: int, lib: Optional[NativeLib] = None,
):
    """Delta+Huffman encode of fiber-major int8 factor buffers into the
    entropy-transport layout (the host mirror of `pack_segments`). Returns
    `(main, exc, chunk_rows, n_rows)`, or None when the rows exceed
    `max_rows_budget` or a delta falls outside the code's alphabet (the
    caller then uses the flat pack)."""
    c_total = sum(b * (-(-int(m) * int(r) // chunk)) for m, r in zip(ms, rs))
    main = np.zeros(c_total * main_words, dtype=np.uint32)
    exc = np.zeros(max_rows_budget * row_words, dtype=np.uint32)
    chunk_rows = np.zeros(c_total, dtype=np.uint8)
    n_rows = np.zeros(1, dtype=np.int64)
    bufs = [np.ascontiguousarray(f, dtype=np.int8) for f in factor_bufs]
    ms_a, rs_a = _i64(ms), _i64(rs)
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    codes32 = np.ascontiguousarray(codes, dtype=np.uint32)
    rc = (lib or LIB).lib().lrf_dpack_encode(
        _ptrs(bufs), len(bufs), b, _ptr(ms_a, ctypes.c_int64), _ptr(rs_a, ctypes.c_int64),
        _ptr(lens32, ctypes.c_int32), _ptr(codes32, ctypes.c_uint32), len(lens32), chunk, main_words, row_words,
        max_rows_budget, _ptr(main, ctypes.c_uint32), _ptr(exc, ctypes.c_uint32), _ptr(chunk_rows, ctypes.c_uint8),
        _ptr(n_rows, ctypes.c_int64),
    )
    if rc in (1, 2):  # over the row budget; a delta outside the alphabet
        return None
    _check(rc, "dpack_encode")
    return main, exc, chunk_rows, int(n_rows[0])


def fiber_cap(max_m: int) -> int:
    """Per-fiber blob capacity handed to the native assemblers; the C side
    allocates and bounds with exactly this value."""
    return int(max_m) + int(max_m) // 8 + 128


def _stream_capacity(b: int, ms, rs, metadata_len: int, inner_md_lens, cap: int) -> int:
    """Upper bound on the bytes of b assembled streams (every fiber blob at `cap`)."""
    per_image = 4 + metadata_len + 4 * (len(ms) - 1)
    for r, mdl in zip(rs, inner_md_lens):
        per_image += 4 + int(mdl) + 4 * (int(r) - 1) + int(r) * cap
    return b * per_image


def _slice_streams(out: np.ndarray, stream_lens: np.ndarray) -> list[bytes]:
    ends = np.cumsum(stream_lens)
    return [out[e - n : e].tobytes() for e, n in zip(ends.tolist(), stream_lens.tolist())]


def assemble_streams(
    factor_bufs: Sequence[np.ndarray], b: int, ms: Sequence[int], rs: Sequence[int], metadata: bytes,
    inner_mds: Sequence[bytes], level: int, backend: str, lib: Optional[NativeLib] = None,
) -> list[bytes]:
    """Finished per-image container streams from `(B, M_k, R_k)` int8 factor
    blocks in one native call: gather, deflate and framing. Bytes equal the
    layered `encode_tensor_batch` + `combine_bytes` assembly."""
    backend_id, level = _backend(backend, level, lib)
    bufs = [np.ascontiguousarray(f, dtype=np.int8) for f in factor_bufs]
    ms_a, rs_a = _i64(ms), _i64(rs)
    md_lens = _i64([len(m) for m in inner_mds])
    cap = fiber_cap(max(ms))
    out_cap = _stream_capacity(b, ms, rs, len(metadata), md_lens, cap)
    out = np.empty(out_cap, dtype=np.uint8)
    stream_lens = np.empty(b, dtype=np.int64)
    rc = (lib or LIB).lib().lrf_assemble_streams(
        _ptrs(bufs), len(bufs), b, _ptr(ms_a, ctypes.c_int64), _ptr(rs_a, ctypes.c_int64), cap, metadata,
        len(metadata), b"".join(inner_mds), _ptr(md_lens, ctypes.c_int64), level, backend_id,
        _ptr(out, ctypes.c_uint8), out_cap, _ptr(stream_lens, ctypes.c_int64),
    )
    _check(rc, "assemble_streams")
    return _slice_streams(out, stream_lens)


def frame_streams(
    slots: np.ndarray, blob_lens: np.ndarray, b: int, rs: Sequence[int], caps: Sequence[int], metadata: bytes,
    inner_mds: Sequence[bytes], lib: Optional[NativeLib] = None,
) -> list[bytes]:
    """Finished per-image container streams from fiber blobs already coded
    (the card's DEFLATE, `ops/deflate.py`): `slots` holds factor k's
    `B * rs[k]` slots of `caps[k]` bytes after factor k-1's, in (image,
    fiber) order, and `blob_lens` (int32) one length per slot. Only the
    framing runs here; bytes equal `assemble_streams`'s for the same blobs."""
    slots = np.ascontiguousarray(slots, dtype=np.uint8).reshape(-1)
    lens = np.ascontiguousarray(blob_lens, dtype=np.int32).reshape(-1)
    rs_a, caps_a = _i64(rs), _i64(caps)
    if slots.size < int((b * rs_a * caps_a).sum()) or lens.size != b * int(rs_a.sum()):
        raise ValueError("frame_streams: the slots or lengths do not fit the factors' shapes")
    md_lens = _i64([len(m) for m in inner_mds])
    out_cap = _stream_capacity(b, caps, rs, len(metadata), md_lens, 0) + b * int((rs_a * caps_a).sum())
    out = np.empty(out_cap, dtype=np.uint8)
    stream_lens = np.empty(b, dtype=np.int64)
    rc = (lib or LIB).lib().lrf_frame_streams(
        slots.ctypes.data_as(ctypes.c_void_p), _ptr(lens, ctypes.c_int32), len(rs_a), b,
        _ptr(rs_a, ctypes.c_int64), _ptr(caps_a, ctypes.c_int64), metadata, len(metadata), b"".join(inner_mds),
        _ptr(md_lens, ctypes.c_int64), _ptr(out, ctypes.c_uint8), out_cap, _ptr(stream_lens, ctypes.c_int64),
    )
    if rc == 2:
        raise RuntimeError("frame_streams: a fiber's blob length lies outside its slot (the coder ran out of room)")
    _check(rc, "frame_streams")
    return _slice_streams(out, stream_lens)


def dpack_assemble_streams(
    main: np.ndarray, exc: np.ndarray, seg_row_base: np.ndarray, b: int, ms: Sequence[int], rs: Sequence[int],
    lens: np.ndarray, codes: np.ndarray, chunk: int, main_words: int, row_words: int, metadata: bytes,
    inner_mds: Sequence[bytes], level: int, backend: str, lib: Optional[NativeLib] = None,
) -> list[bytes]:
    """The fused serializer: entropy-transport buffers -> finished per-image
    streams (Huffman decode, fiber deflate and framing per segment, each
    segment cache-resident). Same bytes as `assemble_streams`."""
    backend_id, level = _backend(backend, level, lib)
    main_b = np.ascontiguousarray(main).view(np.uint8).reshape(-1)
    exc_b = np.ascontiguousarray(exc).view(np.uint8).reshape(-1)
    seg_base = _i64(seg_row_base)
    ms_a, rs_a = _i64(ms), _i64(rs)
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    codes32 = np.ascontiguousarray(codes, dtype=np.uint32)
    md_lens = _i64([len(m) for m in inner_mds])
    cap = fiber_cap(max(ms))
    out_cap = _stream_capacity(b, ms, rs, len(metadata), md_lens, cap)
    out = np.empty(out_cap, dtype=np.uint8)
    stream_lens = np.empty(b, dtype=np.int64)
    rc = (lib or LIB).lib().lrf_dpack_assemble_streams(
        main_b.ctypes.data_as(ctypes.c_void_p), exc_b.ctypes.data_as(ctypes.c_void_p), exc_b.size // (row_words * 4),
        _ptr(seg_base, ctypes.c_int64), len(ms_a), b, _ptr(ms_a, ctypes.c_int64), _ptr(rs_a, ctypes.c_int64), cap,
        _ptr(lens32, ctypes.c_int32), _ptr(codes32, ctypes.c_uint32), len(lens32), chunk, main_words, row_words,
        int(lens32.max()), metadata, len(metadata), b"".join(inner_mds), _ptr(md_lens, ctypes.c_int64), level,
        backend_id, _ptr(out, ctypes.c_uint8), out_cap, _ptr(stream_lens, ctypes.c_int64),
    )
    _check(rc, "dpack_assemble_streams")
    return _slice_streams(out, stream_lens)
