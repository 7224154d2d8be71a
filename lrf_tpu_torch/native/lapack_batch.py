"""ctypes binding of the batched symmetric eigensolver (`lapack_batch.cpp`).

`syevd_batch` eigendecomposes a batch of symmetric matrices in one native
call through LAPACK's `?syevd` as `scipy.linalg.cython_lapack` exports it:
the routine that `scipy.linalg.eigh(driver="evd")` and the JAX package's
CPU `eigh` (jaxlib takes its LAPACK from scipy) both call, with jaxlib's
workspace sizes. It links no LAPACK of its own: the routine's address is
read from scipy's capsule at run time and handed to the library.

Where scipy bundles its own OpenBLAS (`openblas_threads()` is not None),
the library also loads private copies of that OpenBLAS file (dlmopen, one
link namespace each, on one OpenBLAS thread), up to one instance per
available CPU: threads that share one OpenBLAS take turns on the mutex of
its work-buffer pool, while each copy has its own. Each worker of a batch
holds one instance alone; the copies run the same machine code, so the
bits are the same.

The library is built with g++ at first use into the gitignored
`lrf_tpu_torch/_build/` by `fibercodec.py`'s builder (`-O3 -std=c++17
-fPIC -shared -lpthread -ldl`). A missing g++, a failed build or a missing
capsule raises. The call releases the GIL (ctypes does) for the whole
batch. The thread count of scipy's own OpenBLAS is the caller's business
(`ops/svd.py::_host_lapack`).
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path

import numpy as np

from lrf_tpu_torch.native.fibercodec import GxxLib

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_ENTRY = [_P, _P, _P, _I64, _I64, _I32, ctypes.POINTER(ctypes.c_int32)]
_ENTRIES = {np.dtype(np.float32): "lrf_syevd_batch_f32", np.dtype(np.float64): "lrf_syevd_batch_f64"}
# glibc gives a process 16 link namespaces, one of them the program's
_MAX_INSTANCES = 12


class LapackBatchLib(GxxLib):
    source = Path(__file__).resolve().parent / "lapack_batch.cpp"
    stem = "liblapackbatch"
    signatures = {
        "lrf_lapack_instances": (ctypes.c_int, [_P, _P, _P, ctypes.c_int]),
        "lrf_syevd_batch_f32": (ctypes.c_int, _ENTRY),
        "lrf_syevd_batch_f64": (ctypes.c_int, _ENTRY),
    }

    def link_libs(self, cxx: str) -> list[str]:
        return ["-lpthread", "-ldl"]


LIB = LapackBatchLib()


@functools.cache
def openblas_threads():
    """`(get, set)` of the thread count of scipy's bundled OpenBLAS, or None
    where scipy links another LAPACK."""
    try:
        import scipy.linalg._flapack as flapack

        lib = ctypes.CDLL(flapack.__file__)
        return lib.scipy_openblas_get_num_threads, lib.scipy_openblas_set_num_threads
    except (ImportError, OSError, AttributeError):
        return None


def routine(name: str) -> int:
    """The address of `scipy.linalg.cython_lapack`'s `name` ("ssyevd" or
    "dsyevd"), read from its Cython capsule."""
    from scipy.linalg import cython_lapack

    capsule = cython_lapack.__pyx_capi__[name]
    get_name = ctypes.pythonapi.PyCapsule_GetName
    get_name.restype, get_name.argtypes = ctypes.c_char_p, [ctypes.py_object]
    get_pointer = ctypes.pythonapi.PyCapsule_GetPointer
    get_pointer.restype, get_pointer.argtypes = ctypes.c_void_p, [ctypes.py_object, ctypes.c_char_p]
    address = get_pointer(capsule, get_name(capsule))
    if not address:
        raise RuntimeError(f"scipy.linalg.cython_lapack's capsule of {name} holds no function")
    return address


@functools.cache
def instances() -> int:
    """The LAPACK instances the batch's workers share: scipy's own, plus the
    private copies of its OpenBLAS that loaded (up to one instance per
    available CPU, at most `_MAX_INSTANCES`). Loaded at the first call."""
    lib = LIB.lib()
    threads = openblas_threads()
    anchor = ctypes.cast(threads[1], ctypes.c_void_p).value if threads is not None else None
    want = min(len(os.sched_getaffinity(0)), _MAX_INSTANCES)
    count = lib.lrf_lapack_instances(routine("ssyevd"), routine("dsyevd"), anchor, want)
    if count < 1:
        raise RuntimeError("the native ?syevd batch got no LAPACK routine from scipy")
    return count


def syevd_batch(a: np.ndarray, threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """`(w, v)` of a batch `(..., n, n)` of symmetric float32 or float64
    matrices: eigenvalues ascending `(..., n)` and eigenvectors `(..., n,
    n)` with eigenvector j in column j, as `scipy.linalg.eigh(a,
    driver="evd")` gives them (its lower triangle is read).

    `threads` workers, at most one per matrix and per instance (0: one per
    instance), each holding one instance alone, take the matrices one at a
    time from a shared counter, so that a worker whose core is busy takes
    fewer. With one worker the batch runs on the calling thread
    through scipy's own instance, on the thread count scipy's OpenBLAS has.
    Raises `np.linalg.LinAlgError` naming the first matrix whose `info` is
    not 0.
    """
    a = np.ascontiguousarray(a)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"syevd_batch takes a batch of square matrices, not {a.shape}")
    if a.dtype not in _ENTRIES:
        raise TypeError(f"syevd_batch takes float32 or float64, not {a.dtype}")
    n = a.shape[-1]
    flat = a.reshape(-1, n, n)
    count = flat.shape[0]
    w = np.empty((count, n), a.dtype)
    v = np.empty_like(flat)
    if count and n:
        instances()
        info = np.zeros(count, np.int32)
        entry = _ENTRIES[a.dtype]
        rc = getattr(LIB.lib(), entry)(
            flat.ctypes.data, w.ctypes.data, v.ctypes.data, count, n, threads,
            info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:
            raise RuntimeError(f"{entry} failed with code {rc} on {count} matrices of order {n}")
        bad = np.flatnonzero(info)
        if bad.size:
            name = "ssyevd" if a.dtype == np.float32 else "dsyevd"
            raise np.linalg.LinAlgError(
                f"{name} failed on matrix {bad[0]} of {count} (info {info[bad[0]]}; {bad.size} failed)"
            )
    return w.reshape(a.shape[:-1]), v.reshape(a.shape)
