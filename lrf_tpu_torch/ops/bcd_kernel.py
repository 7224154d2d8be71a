"""The fused BCD loop as one hand-written CUDA kernel, and its plain version.

Port of `lrf_tpu/ops/bcd_pallas.py` (`bcd_pallas` and `_bcd_pallas_legacy`,
kernels K1-K3). `bcd(x, u0, v0, num_iters, bounds)` runs `num_iters`
projected Gauss-Seidel sweeps (U update, then V update) on `(B, M, N)`
patch stacks and returns integer-valued float32 `(u, v)`:

- on CUDA tensors it launches `csrc/bcd.cu` (one thread block per image,
  all sweeps in one launch) and counts the launch;
- on CPU tensors it runs `bcd_reference`, the plain PyTorch version;
- anything else raises. There is no fallback from one to the other.

The kernel library is compiled with `nvcc` for `sm_90a` at first use into
`lrf_tpu_torch/_build/` and loaded with ctypes; importing this module needs
neither `nvcc` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

from lrf_tpu_torch.ops.bcd import bcd_sweep, make_project

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "bcd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def launch_plan(m: int, n: int, r: int, threads: int, smem_optin: int) -> tuple[int, bool, int]:
    """(tile rows T, smem_mode, dynamic shared memory bytes) for one shape.

    `threads` is the kernel's block size and `smem_optin` the bytes of
    shared memory a block may opt into. The X and U tiles always live in
    shared memory (rows padded to odd strides, as the kernel lays them out).
    V, the Grams and X^T U join them while that leaves a tile of at least
    min(M, 32) rows; else they go to global scratch and the tile takes all
    the room.
    """
    budget = smem_optin // 4  # floats
    row = (n | 1) + (r | 1)  # one tile row of X and of U
    small = 2 * n * r + 2 * r * r  # V, X^T U, V^T V, U^T U
    t = min(m, threads, max(0, budget - small) // row)
    if t >= min(m, 32):
        return t, True, 4 * (t * row + small)
    t = min(m, threads, budget // row)
    if t < 1:
        raise ValueError(
            f"the bcd kernel needs one row of X and U ({row} floats) in {budget} floats "
            f"of shared memory; got N={n} R={r}"
        )
    return t, False, 4 * t * row


class _KernelLib:
    """The compiled library, built and loaded on first use, and the count of
    kernel launches made through `bcd`."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._smem_optin = 0
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"libbcd_{digest[:16]}.so"

    def build(self) -> Path:
        """Compile the kernel library unless this source's build exists."""
        path = self.library_path()
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{self.build_log}")
        os.replace(tmp, path)
        return path

    def lib(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                lib.lrf_bcd_launch.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_size_t,
                    ctypes.c_void_p,
                ]
                lib.lrf_bcd_launch.restype = ctypes.c_int
                lib.lrf_bcd_threads.argtypes = []
                lib.lrf_bcd_threads.restype = ctypes.c_int
                lib.lrf_bcd_smem_optin.argtypes = [ctypes.POINTER(ctypes.c_int)]
                lib.lrf_bcd_smem_optin.restype = ctypes.c_int
                lib.lrf_cuda_error_string.argtypes = [ctypes.c_int]
                lib.lrf_cuda_error_string.restype = ctypes.c_char_p
                optin = ctypes.c_int(0)
                self._check(lib, lib.lrf_bcd_smem_optin(ctypes.byref(optin)), "smem query")
                self._smem_optin = optin.value
                self._lib = lib
            return self._lib

    @staticmethod
    def _check(lib, err: int, what: str) -> None:
        if err != 0:
            msg = lib.lrf_cuda_error_string(err).decode()
            raise RuntimeError(f"bcd kernel {what} failed: CUDA error {err} ({msg})")

    def plan(self, m: int, n: int, r: int) -> tuple[int, bool, int]:
        """`launch_plan` for the current device."""
        threads = self.lib().lrf_bcd_threads()
        return launch_plan(m, n, r, threads, self._smem_optin)

    def launch(self, x, u, v, num_iters: int, lo: float, hi: float) -> None:
        lib = self.lib()
        b, m, n = x.shape
        r = u.shape[-1]
        tile, smem_mode, smem_bytes = self.plan(m, n, r)
        scratch = None
        if not smem_mode:
            scratch = torch.empty(b * (n * r + 2 * r * r), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lrf_bcd_launch(
            x.data_ptr(), u.data_ptr(), v.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b, m, n, r, tile, num_iters, lo, hi, int(smem_mode), smem_bytes, stream,
        )
        self._check(lib, err, "launch")
        self.launches += 1


KERNEL = _KernelLib()


def _int_bounds(bounds) -> tuple[float, float]:
    lo, hi = bounds
    lo = -math.inf if lo is None else float(math.ceil(lo))
    hi = math.inf if hi is None else float(math.floor(hi))
    return lo, hi


def bcd_reference(x, u0, v0, num_iters: int = 10, bounds=(-16, 15)):
    """Plain PyTorch version: `num_iters` calls of `bcd_sweep(..., factor=(0, 1))`."""
    x = x.to(torch.float32)
    u, v = u0.to(torch.float32), v0.to(torch.float32)
    w = torch.cat([torch.zeros_like(x[..., :1, :1]), torch.ones_like(x[..., :1, :1])], dim=-2)
    project = make_project(bounds)
    for _ in range(num_iters):
        u, v, w = bcd_sweep(x, u, v, w, factor=(0, 1), project=project)
    return u, v


def bcd(
    x: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    num_iters: int = 10,
    bounds: tuple[Optional[float], Optional[float]] = (-16, 15),
):
    """`num_iters` BCD sweeps on `x (B, M, N)` from `u0 (B, M, R)`, `v0 (B, N, R)`.

    Returns integer-valued float32 `(u, v)`. CUDA tensors go through the
    kernel, CPU tensors through `bcd_reference`; `num_iters=0` returns the
    init as float32 without a launch.
    """
    if x.ndim != 3 or u0.ndim != 3 or v0.ndim != 3:
        raise ValueError(f"bcd takes (B, M, N), (B, M, R), (B, N, R); got {x.shape}, {u0.shape}, {v0.shape}")
    b, m, n = x.shape
    r = u0.shape[-1]
    if u0.shape != (b, m, r) or v0.shape != (b, n, r):
        raise ValueError(f"factor shapes {tuple(u0.shape)}, {tuple(v0.shape)} do not fit X {tuple(x.shape)}")
    if num_iters < 0:
        raise ValueError("num_iters must be >= 0")
    devices = {x.device, u0.device, v0.device}
    if len(devices) != 1:
        raise ValueError(f"bcd inputs lie on several devices: {devices}")
    if x.device.type == "cpu":
        return bcd_reference(x, u0, v0, num_iters=num_iters, bounds=bounds)
    if x.device.type != "cuda":
        raise ValueError(f"bcd runs on CUDA or CPU tensors, not {x.device}")
    if num_iters == 0:
        return u0.to(torch.float32), v0.to(torch.float32)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the bcd kernel takes a contiguous float32 X")
    if not (u0.is_floating_point() and v0.is_floating_point()):
        raise ValueError("the bcd kernel takes floating-point factors")
    if b == 0 or m == 0 or n == 0 or r == 0:
        raise ValueError(f"the bcd kernel takes non-empty shapes, got B={b} M={m} N={n} R={r}")
    if max(b * m * n, b * m * r, b * n * r) >= 2**31 or m * n >= 2**31:
        raise ValueError("the bcd kernel takes fewer than 2**31 elements per tensor")
    lo, hi = _int_bounds(bounds)
    with torch.cuda.device(x.device):
        u = torch.empty((b, m, r), dtype=torch.float32, device=x.device)
        v = torch.empty((b, n, r), dtype=torch.float32, device=x.device)
        u.copy_(u0)
        v.copy_(v0)
        KERNEL.launch(x, u, v, num_iters, lo, hi)
    return u, v
