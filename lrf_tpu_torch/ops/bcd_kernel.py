"""The fused BCD loop as hand-written CUDA kernels, and its plain version.

Port of `lrf_tpu/ops/bcd_pallas.py` (`bcd_pallas` and `_bcd_pallas_legacy`,
kernels K1-K3). `bcd(x, u0, v0, num_iters, bounds)` runs `num_iters`
projected Gauss-Seidel sweeps (U update, then V update) on `(B, M, N)`
patch stacks and returns integer-valued float32 `(u, v)`:

- on CUDA tensors it launches one of two kernels, chosen by `launch_plan`
  from the shape alone, and counts the launch:
  - `csrc/bcd_cluster.cu` at the codec's patch width (N = 64, R <= 16): a
    thread-block cluster per image splits M, each CTA holding its slice of
    X in shared memory across all sweeps (or streaming it when it does not
    fit);
  - `csrc/bcd.cu` for wider state (N != 64 or R > 16): one thread block
    per image, X streamed through shared memory every sweep;
- on CPU tensors it runs `bcd_reference`, the plain PyTorch version;
- anything else raises. There is no fallback from one to the other.

The kernel libraries are compiled with `nvcc` for `sm_90a` at first use into
`lrf_tpu_torch/_build/` (one nvcc per source, started together) and loaded
with ctypes; importing this module needs neither `nvcc` nor a GPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The two kernels: name -> source under csrc/.
SOURCES = {"bcd_cluster": "bcd_cluster.cu", "bcd": "bcd.cu"}

# Geometry of bcd_cluster.cu (its kN, kThreads, kMaxRank, kMaxCluster) and
# of bcd.cu (kThreads).
CLUSTER_N = 64
CLUSTER_THREADS = 256
CLUSTER_MAX_RANK = 16
CLUSTER_MAX = 16
STREAM_TILE = 256
BLOCK_THREADS = 512


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one shape runs.

    `variant` is "bcd_cluster" or "bcd". `cluster` CTAs per image each own
    `rows_per_cta` rows of X; `resident` says whether that slice stays in
    shared memory for all sweeps (else it streams through `tile`-row tiles).
    For "bcd" (one block per image, X always streamed), `state_in_smem` says
    whether V, the Grams and X^T U sit in shared memory or in a global
    scratch.
    """

    variant: str
    cluster: int
    rows_per_cta: int
    resident: bool
    tile: int
    smem_bytes: int
    state_in_smem: bool = True


def _round4(x: int) -> int:
    return (x + 3) & ~3


def cluster_smem_bytes(s: int, t: int, r: int, warps: int = CLUSTER_THREADS // 32) -> int:
    """Bytes of shared memory of one bcd_cluster CTA (its `Layout`): the X
    tile(s), the U tile(s), V at float4 row stride, V^T V,
    two partials by sweep parity and warps/2 tree slots (a partial holds
    X^T U and one U^T U row per lane of a row group)."""
    n = CLUSTER_N
    tile, nbuf = (s, 1) if s <= t else (t, 2)
    ps = _round4(n * r + r * (8 if r <= 8 else 16))  # lane-major partial
    floats = nbuf * tile * n + _round4(nbuf * tile * r) + n * _round4(r) + _round4(r * r)
    return 4 * (floats + 2 * ps + (warps // 2) * ps)


def _block_plan(m: int, n: int, r: int, smem_optin: int) -> Plan:
    """bcd.cu: one block per image. The X and U tiles always live in shared
    memory (rows padded to odd strides, as the kernel lays them out). V, the
    Grams and X^T U join them while that leaves a tile of at least
    min(M, 32) rows; else they go to global scratch and the tile takes all
    the room."""
    budget = smem_optin // 4  # floats
    row = (n | 1) + (r | 1)  # one tile row of X and of U
    small = 2 * n * r + 2 * r * r  # V, X^T U, V^T V, U^T U
    t = min(m, BLOCK_THREADS, max(0, budget - small) // row)
    if t >= min(m, 32):
        return Plan("bcd", 1, m, False, t, 4 * (t * row + small), True)
    t = min(m, BLOCK_THREADS, budget // row)
    if t < 1:
        raise ValueError(
            f"the bcd kernel needs one row of X and U ({row} floats) in {budget} floats "
            f"of shared memory; got N={n} R={r}"
        )
    return Plan("bcd", 1, m, False, t, 4 * t * row, False)


def _cluster_plan(m: int, r: int, smem_optin: int) -> Plan:
    """bcd_cluster.cu: the smallest cluster whose CTAs hold their X slice
    resident; else the largest cluster, streaming STREAM_TILE-row tiles."""
    c = 1
    while c <= CLUSTER_MAX:
        s = -(-m // c)
        smem = cluster_smem_bytes(s, s, r)
        if smem <= smem_optin:
            return Plan("bcd_cluster", c, s, True, s, smem)
        c *= 2
    s = -(-m // CLUSTER_MAX)
    smem = cluster_smem_bytes(s, STREAM_TILE, r)
    if smem > smem_optin:
        raise ValueError(f"the bcd_cluster kernel needs {smem} B of shared memory, the device has {smem_optin}")
    return Plan("bcd_cluster", CLUSTER_MAX, s, False, STREAM_TILE, smem)


def launch_plan(m: int, n: int, r: int, smem_optin: int, variant: Optional[str] = None) -> Plan:
    """The kernel and launch geometry for X (M, N) at rank R, from the shape
    alone (never the batch, so an image's result does not depend on it).

    `smem_optin` is the shared memory a block may opt into. `variant`
    forces one kernel (for same-run comparisons); by default the cluster
    kernel takes N = 64 with R <= 16 and bcd.cu the rest.
    """
    if variant is None:
        variant = "bcd_cluster" if n == CLUSTER_N and 1 <= r <= CLUSTER_MAX_RANK else "bcd"
    if variant == "bcd":
        return _block_plan(m, n, r, smem_optin)
    if variant != "bcd_cluster":
        raise ValueError(f"unknown bcd kernel {variant!r}")
    if n != CLUSTER_N or not 1 <= r <= CLUSTER_MAX_RANK:
        raise ValueError(f"the bcd_cluster kernel takes N = {CLUSTER_N} and R <= {CLUSTER_MAX_RANK}; got N={n} R={r}")
    return _cluster_plan(m, r, smem_optin)


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _bind(lib, name: str, restype, *argtypes) -> None:
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = restype


_P, _I, _F, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t


class _KernelLib:
    """The compiled libraries, built and loaded on first use, and the count
    of kernel launches made through `bcd`, per kernel."""

    def __init__(self, defines: tuple[str, ...] = ()):
        self.defines = tuple(defines)  # extra nvcc flags, e.g. a profiling build's -D
        self.counts = {name: 0 for name in SOURCES}
        self.build_log = ""
        self._lib = None  # name -> ctypes.CDLL, once loaded
        self._smem_optin = 0
        self._lock = threading.Lock()

    @property
    def launches(self) -> int:
        """Launches of both kernels together."""
        return sum(self.counts.values())

    def digest(self) -> str:
        """Hash of every file under csrc/ (names and contents) and the nvcc flags."""
        h = hashlib.sha256(" ".join(NVCC_FLAGS + self.defines).encode())
        for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
            h.update(str(path.relative_to(CSRC)).encode() + b"\0")
            h.update(path.read_bytes() + b"\0")
        return h.hexdigest()[:16]

    def library_path(self, name: str = "bcd_cluster") -> Path:
        return BUILD_DIR / f"lib{name}_{self.digest()}.so"

    def build(self) -> dict:
        """Compile every kernel library whose build for these sources is
        missing, one nvcc per source, all started together."""
        paths = {name: self.library_path(name) for name in SOURCES}
        todo = {name: p for name, p in paths.items() if not p.exists()}
        if not todo:
            return paths
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _find_nvcc()
        procs = {}
        for name, path in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, *self.defines, "-o", tmp, str(CSRC / SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
        logs, failed = [], []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            logs.append(f"== {SOURCES[name]}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{SOURCES[name]} ({proc.returncode})")
                os.unlink(tmp)
            else:
                os.replace(tmp, todo[name])
        self.build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{self.build_log}")
        return paths

    def lib(self) -> dict:
        with self._lock:
            if self._lib is None:
                paths = self.build()
                libs = {name: ctypes.CDLL(str(p)) for name, p in paths.items()}
                block, cluster = libs["bcd"], libs["bcd_cluster"]
                _bind(block, "lrf_bcd_launch", _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _Z, _P)
                _bind(block, "lrf_bcd_threads", _I)
                _bind(block, "lrf_bcd_smem_optin", _I, ctypes.POINTER(_I))
                _bind(block, "lrf_cuda_error_string", ctypes.c_char_p, _I)
                _bind(cluster, "lrf_bcdc_launch", _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _Z, _P)
                _bind(cluster, "lrf_bcdc_threads", _I)
                _bind(cluster, "lrf_bcdc_max_rank", _I)
                _bind(cluster, "lrf_bcdc_max_cluster", _I)
                _bind(cluster, "lrf_bcdc_max_active_clusters", _I, _I, _I, _Z, ctypes.POINTER(_I))
                _bind(cluster, "lrf_cuda_error_string", ctypes.c_char_p, _I)
                geometry = (
                    (block.lrf_bcd_threads(), BLOCK_THREADS),
                    (cluster.lrf_bcdc_threads(), CLUSTER_THREADS),
                    (cluster.lrf_bcdc_max_rank(), CLUSTER_MAX_RANK),
                    (cluster.lrf_bcdc_max_cluster(), CLUSTER_MAX),
                )
                if any(got != want for got, want in geometry):
                    raise RuntimeError(f"kernel geometry {geometry} does not match bcd_kernel.py")
                optin = ctypes.c_int(0)
                self._check(block, block.lrf_bcd_smem_optin(ctypes.byref(optin)), "smem query")
                self._smem_optin = optin.value
                self._lib = libs
            return self._lib

    @staticmethod
    def _check(lib, err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"bcd kernel {what} failed: CUDA error {err} ({lib.lrf_cuda_error_string(err).decode()})")

    def plan(self, m: int, n: int, r: int, variant: Optional[str] = None) -> Plan:
        """`launch_plan` for the current device."""
        self.lib()
        return launch_plan(m, n, r, self._smem_optin, variant)

    def max_active_clusters(self, plan: Plan, r: int) -> int:
        """Clusters of `plan` that the device runs at once (bcd_cluster only)."""
        lib = self.lib()["bcd_cluster"]
        out = ctypes.c_int(0)
        self._check(lib, lib.lrf_bcdc_max_active_clusters(r, plan.cluster, plan.smem_bytes, ctypes.byref(out)),
                    "occupancy query")
        return out.value

    def launch(self, x, u, v, num_iters: int, lo: float, hi: float, variant: Optional[str] = None) -> None:
        """Run the sweeps in place on `u`, `v`; `variant` forces a kernel."""
        libs = self.lib()
        b, m, n = x.shape
        r = u.shape[-1]
        plan = launch_plan(m, n, r, self._smem_optin, variant)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.variant == "bcd_cluster":
            lib = libs["bcd_cluster"]
            if x.data_ptr() % 16:
                x = x.clone()  # cp.async copies 16-byte chunks
            err = lib.lrf_bcdc_launch(
                x.data_ptr(), u.data_ptr(), v.data_ptr(), b, m, r, plan.cluster, plan.rows_per_cta,
                plan.tile, num_iters, lo, hi, plan.smem_bytes, stream,
            )
        else:
            lib = libs["bcd"]
            scratch = None
            if not plan.state_in_smem:
                scratch = torch.empty(b * (n * r + 2 * r * r), dtype=torch.float32, device=x.device)
            err = lib.lrf_bcd_launch(
                x.data_ptr(), u.data_ptr(), v.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                b, m, n, r, plan.tile, num_iters, lo, hi, int(plan.state_in_smem), plan.smem_bytes, stream,
            )
        self._check(lib, err, f"{plan.variant} launch")
        self._count(plan.variant)

    def _count(self, variant: str) -> None:
        with self._lock:  # data-mesh rows launch from threads of their own
            self.counts[variant] += 1


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
    kernel `launch_plan` picks, CPU tensors through `bcd_reference`;
    `num_iters=0` returns the init as float32 without a launch.
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
