"""zlib level-9 DEFLATE of a batch's int8 factor fibers on the card, and
its host twin.

`deflate_fibers(factors)` codes every fiber (column r of image b) of int8
`(B, M, R)` factors on their CUDA device into a zlib stream byte for byte
`zlib.compress(fiber, 9)` (zlib 1.2.12 and later), with the kernel of
`csrc/deflate.cu`: one launch per group of factors that share M, on the
current stream, counted in `KERNEL.counts`. It returns the streams in
fixed slots (`slot_caps`) and their lengths, for one copy to the host,
where `native/fibercodec.py::frame_streams` frames them. Under a profiler
each launch records a `lrf.encode.deflate.launch` span.

`csrc/deflate_core.h` holds the match search, zlib's lazy parse and its
block coder, which the kernel and the host twin (`native/deflate_twin.cpp`,
g++) both compile. The twin builds the hash chains and walks them in plain
loops; it is the plain version the tests hold against zlib, and the
encoder never runs it.

The kernel library is built with nvcc at first use into `_build/`, like
the BCD kernels (`ops/bcd_kernel.py`); importing this module needs neither
nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from lrf_tpu_torch.native import fibercodec as _native
from lrf_tpu_torch.native.fibercodec import GxxLib
from lrf_tpu_torch.ops.bcd_kernel import BUILD_DIR, CSRC, NVCC_FLAGS, _find_nvcc
from lrf_tpu_torch.utils import profiling

SOURCE = CSRC / "deflate.cu"
CORE = CSRC / "deflate_core.h"
TWIN_SOURCE = Path(_native.__file__).resolve().parent / "deflate_twin.cpp"
# deflate_core.h's kMaxFiber: past it zlib slides its window, which the
# kernel and the twin do not model.
MAX_FIBER = 65273

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The span of one launch, recorded while a profiler runs (`utils/profiling.py`):
# its `attrs` hold M and the fiber count, `bytes_in` the fibers' bytes.
LAUNCH_SPAN = "lrf.encode.deflate.launch"


def slot_caps(ms: Sequence[int]) -> list[int]:
    """Bytes of one fiber's output slot, per factor: the host serializer's
    per-fiber capacity (`fibercodec.fiber_cap`), above zlib's bound."""
    return [_native.fiber_cap(m) for m in ms]


class _DeflateLib:
    """The kernel library, built and loaded on first use, and its launch count."""

    def __init__(self):
        self.counts = {"deflate": 0}
        self.build_seconds: Optional[float] = None
        self._lib = None
        self._max_fiber = 0
        self._lock = threading.Lock()

    @property
    def launches(self) -> int:
        return self.counts["deflate"]

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in (SOURCE, CORE):
            h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
        return BUILD_DIR / f"libdeflate_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        path = self.library_path()
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True,
                                  text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE.name} ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
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
                lib.lrf_deflate_launch.argtypes = [_I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P]
                lib.lrf_deflate_launch.restype = _I
                lib.lrf_deflate_max_fiber.argtypes = [ctypes.POINTER(_I)]
                lib.lrf_deflate_max_fiber.restype = _I
                lib.lrf_deflate_max_factors.restype = _I
                lib.lrf_deflate_global_rank.argtypes = [_I, ctypes.POINTER(_I)]
                lib.lrf_deflate_global_rank.restype = _I
                lib.lrf_cuda_error_string.argtypes = [_I]
                lib.lrf_cuda_error_string.restype = ctypes.c_char_p
                out = _I(0)
                self._check(lib, lib.lrf_deflate_max_fiber(ctypes.byref(out)), "shared memory query")
                self._max_fiber = out.value
                self._lib = lib
            return self._lib

    @staticmethod
    def _check(lib, err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"deflate kernel {what} failed: CUDA error {err} ({lib.lrf_cuda_error_string(err).decode()})")

    def max_fiber(self) -> int:
        """The longest fiber the kernel takes on the current device."""
        self.lib()
        return self._max_fiber

    def launch(self, factors: Sequence[torch.Tensor], m: int, cap: int, slot_base: Sequence[int],
               lens_base: Sequence[int], out: torch.Tensor, lens: torch.Tensor) -> None:
        """One launch over `factors`, which all have M = m."""
        lib = self.lib()
        nf = len(factors)
        srcs = (_P * nf)(*[f.data_ptr() for f in factors])
        bs = (_I * nf)(*[int(f.shape[0]) for f in factors])
        rs = (_I * nf)(*[int(f.shape[2]) for f in factors])
        global_rank = _I(0)
        self._check(lib, lib.lrf_deflate_global_rank(m, ctypes.byref(global_rank)), "shared memory query")
        rank = None  # the positions' ranks, where shared memory cannot hold them
        if global_rank.value:
            rank = torch.empty(m * sum(int(f.shape[0]) * int(f.shape[2]) for f in factors), dtype=torch.int32,
                               device=out.device)
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.lrf_deflate_launch(
            nf, srcs, bs, rs, m, cap, (_LL * nf)(*slot_base), (_LL * nf)(*lens_base), out.data_ptr(),
            lens.data_ptr(), None if rank is None else rank.data_ptr(), stream,
        )
        self._check(lib, err, "launch")
        with self._lock:  # data-mesh rows may launch from threads of their own
            self.counts["deflate"] += 1


KERNEL = _DeflateLib()

_SIDE: dict = {}
_SIDE_LOCK = threading.Lock()


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream of `device` on which the encoder runs the DEFLATE and its
    fetch, so that the next batch's work on the current stream does not
    wait for them (one per device, made at first use). It has CUDA's
    default priority, which is also its lowest."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    with _SIDE_LOCK:
        if index not in _SIDE:
            _SIDE[index] = torch.cuda.Stream(device=index)
        return _SIDE[index]


def deflate_fibers(factors: Sequence[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """zlib-9 streams of every fiber of int8 `(B, M_k, R_k)` factors on one
    CUDA device, coded on the card.

    Returns `(slots, lens)` on that device: `slots` (uint8) holds factor k's
    `B * R_k` slots of `slot_caps(M)[k]` bytes after factor k-1's, in
    (image, fiber) order, each starting with its stream; `lens` (int32)
    holds each stream's length in the same order (-1 where a slot was too
    small). No host synchronisation; the work runs on the current stream.
    """
    if not factors:
        raise ValueError("deflate_fibers takes at least one factor")
    device = factors[0].device
    if device.type != "cuda":
        raise ValueError(f"deflate_fibers codes on a CUDA device, not {device}")
    for f in factors:
        if f.device != device or f.dtype != torch.int8 or f.ndim != 3:
            raise ValueError("deflate_fibers takes int8 (B, M, R) factors on one CUDA device")
    factors = [f.contiguous() for f in factors]
    ms = [int(f.shape[1]) for f in factors]
    caps = slot_caps(ms)
    with torch.cuda.device(device):
        if max(ms) > KERNEL.max_fiber():
            raise ValueError(f"fibers of {max(ms)} bytes exceed the kernel's {KERNEL.max_fiber()}")
        per = [int(f.shape[0]) * int(f.shape[2]) for f in factors]
        slot_base, lens_base = [0], [0]
        for p, c in zip(per, caps):
            slot_base.append(slot_base[-1] + p * c)
            lens_base.append(lens_base[-1] + p)
        out = torch.empty(slot_base[-1], dtype=torch.uint8, device=device)
        lens = torch.empty(lens_base[-1], dtype=torch.int32, device=device)
        max_group = KERNEL.lib().lrf_deflate_max_factors()
        for m in sorted({m for m, p in zip(ms, per) if p}, reverse=True):  # longest fibers first
            group = [k for k in range(len(factors)) if ms[k] == m and per[k]]
            for i in range(0, len(group), max_group):
                ks = group[i : i + max_group]
                with profiling.span(LAUNCH_SPAN) as s:
                    KERNEL.launch([factors[k] for k in ks], m, caps[ks[0]], [slot_base[k] for k in ks],
                                  [lens_base[k] for k in ks], out, lens)
                    if s is not None:
                        fibers = sum(per[k] for k in ks)
                        s.attrs, s.bytes_in = {"M": m, "fibers": fibers}, m * fibers
    return out, lens


class TwinLib(GxxLib):
    """The host twin (`native/deflate_twin.cpp`), built with g++ at first use."""

    source = TWIN_SOURCE
    stem = "libdeflatetwin"
    headers = (CORE,)
    signatures = {
        "lrf_deflate_twin": (_I, [ctypes.c_char_p, ctypes.c_int64, _P, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int64)]),
        "lrf_deflate_twin_max_fiber": (_I, []),
    }


TWIN = TwinLib()


def twin_compress(data: bytes) -> bytes:
    """The host twin's zlib stream of `data` (at most MAX_FIBER bytes)."""
    data = bytes(data)
    if len(data) > MAX_FIBER:
        raise ValueError(f"the twin takes fibers of at most {MAX_FIBER} bytes, got {len(data)}")
    cap = _native.fiber_cap(len(data))
    out = ctypes.create_string_buffer(cap)
    n = ctypes.c_int64(0)
    rc = TWIN.lib().lrf_deflate_twin(data, len(data), out, cap, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"the deflate twin failed with code {rc}")
    return out.raw[: n.value]
