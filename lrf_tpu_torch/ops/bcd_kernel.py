"""The fused BCD loop as hand-written CUDA kernels, and its plain version.

Port of `lrf_tpu/ops/bcd_pallas.py` (`bcd_pallas` and `_bcd_pallas_legacy`,
kernels K1-K3). `bcd(x, u0, v0, num_iters, bounds)` runs `num_iters`
projected Gauss-Seidel sweeps (U update, then V update) on `(B, M, N)`
patch stacks and returns integer-valued float32 `(u, v)`:

- on CUDA tensors it launches one of three kernels, chosen by `launch_plan`
  from the shape alone, and counts the launch:
  - at the codec's patch width (N = 64, 1 <= R <= 32) the cluster kernel of
    `csrc/bcd_cluster.cuh`: a thread-block cluster per image splits M, each
    CTA holding its slice of X in shared memory across all sweeps (or
    streaming it when it does not fit). Its ranks 1-16 build from
    `csrc/bcd_cluster.cu` ("bcd_cluster") and 17-32 from
    `csrc/bcd_cluster_wide.cu` ("bcd_cluster_wide"), in two nvcc processes;
  - `csrc/bcd_grid.cu` ("bcd_grid") for the other shapes (N != 64 or
    R > 32): one image split over a grid of CTAs by M tiles, each
    half-sweep a grid-wide phase, R a run-time argument;
  `csrc/bcd.cu` ("bcd", one thread block per image) takes every shape but
  runs only when forced (`KERNEL.launch(..., variant="bcd")`), as the
  yardstick of same-run comparisons;
- on CPU tensors it runs `bcd_reference`, the plain PyTorch version;
- anything else raises. There is no fallback from one to the other.

`qmf_decompose_cuda` is the SVD init followed by `bcd`, the counterpart of
`lrf_tpu.ops.bcd_pallas.qmf_decompose_pallas`. `lrf_tpu_torch.ops` exports
`bcd` as `bcd_cuda` (its name `bcd` is the solver's module there).

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
import time
from pathlib import Path
from typing import Optional

import torch

from lrf_tpu_torch.ops.bcd import bcd_sweep, make_project, svd_init, update_columns

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The kernels: name -> source under csrc/ (one library, one nvcc each).
SOURCES = {
    "bcd_cluster": "bcd_cluster.cu",
    "bcd_cluster_wide": "bcd_cluster_wide.cu",
    "bcd_grid": "bcd_grid.cu",
    "bcd": "bcd.cu",
}

# Geometry of bcd_cluster.cuh (its kN, kThreads, kMaxCluster, and each
# source's kMinRank..kMaxRank), of bcd_grid.cu (kThreads, kBlock, kChunk)
# and of bcd.cu (kThreads).
CLUSTER_N = 64
CLUSTER_THREADS = 256
CLUSTER_RANKS = {"bcd_cluster": (1, 16), "bcd_cluster_wide": (17, 32)}
CLUSTER_MAX = 16
# Streamed tiles, largest first: the plan takes the largest that fits (128
# rows fit at every rank up to 32). At most CLUSTER_THREADS rows, so a
# thread updates one row of a tile.
STREAM_TILES = (256, 128)
BLOCK_THREADS = 512
GRID_THREADS = 256
# bcd_grid tiles: at most GRID_TILE rows (the kernel's A = X V covers one
# 64-row block), halved down to GRID_MIN_TILE while an image would fill
# fewer than GRID_MIN_CTAS CTAs, then halved further while a tile does not
# fit in shared memory.
GRID_TILE = 64
GRID_MIN_TILE = 8
GRID_MIN_CTAS = 16
GRID_CHUNK = 32 * 64  # one staged chunk of V: kChunk x kBlock floats


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one shape runs.

    `variant` is "bcd_cluster" (N = 64, R <= 16), "bcd_cluster_wide"
    (N = 64, 17 <= R <= 32), "bcd_grid" (the rest) or "bcd" (forced only).
    `cluster` CTAs per image each own `rows_per_cta` rows of X; `resident`
    says whether that slice stays in shared memory for all sweeps (else it
    streams through `tile`-row tiles). For "bcd_grid" `cluster` is the
    number of M tiles (a grid, not a thread-block cluster), each of `tile`
    rows; `state_in_smem` says whether V^T V sits in shared memory beside
    the tile, and `scratch_floats` is the global scratch per image (tile
    partials, their sums, V^T V). For "bcd" (one block per image, X always
    streamed), `state_in_smem` says whether V, the Grams and X^T U sit in
    shared memory or in a global scratch.
    """

    variant: str
    cluster: int
    rows_per_cta: int
    resident: bool
    tile: int
    smem_bytes: int
    state_in_smem: bool = True
    scratch_floats: int = 0


def _round4(x: int) -> int:
    return (x + 3) & ~3


def cluster_smem_bytes(s: int, t: int, r: int, warps: int = CLUSTER_THREADS // 32) -> int:
    """Bytes of shared memory of one cluster-kernel CTA (its `Layout` in
    bcd_cluster.cuh): the X tile(s), the U tile(s) (rows at stride R, or
    round4(R) at R > 16), V at float4 row stride, V^T V, two partials by
    sweep parity and warps/2 tree slots (a partial holds X^T U, then U^T U
    rows at a stride of 8 or 16 lanes at R <= 16, of R above)."""
    n = CLUSTER_N
    tile, nbuf = (s, 1) if s <= t else (t, 2)
    u_stride = r if r <= 16 else _round4(r)
    g_stride = 8 if r <= 8 else 16 if r <= 16 else r
    ps = _round4(n * r + r * g_stride)  # lane-major partial
    floats = nbuf * tile * n + _round4(nbuf * tile * u_stride) + n * _round4(r) + _round4(r * r)
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


def grid_smem_bytes(t: int, n: int, r: int, g_smem: bool) -> int:
    """Bytes of shared memory of one bcd_grid U-phase CTA (`u_smem_floats`
    in bcd_grid.cu): the X tile at odd row stride N | 1, the U and residual
    tiles at odd row stride R | 1, one staged chunk of V, and V^T V when it
    sits there."""
    return 4 * (t * (n | 1) + 2 * t * (r | 1) + GRID_CHUNK + (r * r if g_smem else 0))


def grid_scratch_floats(m: int, n: int, r: int, t: int) -> int:
    """Global scratch of bcd_grid per image, in floats: each tile's partials
    of X^T U and U^T U, their sums over tiles, and V^T V."""
    e = n * r + r * r
    return -(-m // t) * e + e + r * r


def _grid_plan(m: int, n: int, r: int, smem_optin: int) -> Plan:
    """bcd_grid.cu: one image over ceil(M / T) CTAs. T depends on (M, N, R)
    only: GRID_TILE rows, halved while the image would fill fewer than
    GRID_MIN_CTAS CTAs (not below GRID_MIN_TILE), at most M; V^T V beside
    the tile when it fits, else in the scratch; T halved further while the
    tile does not fit."""
    t = GRID_TILE
    while t > GRID_MIN_TILE and -(-m // t) < GRID_MIN_CTAS:
        t //= 2
    t = min(t, m)
    while True:
        for g_smem in (True, False):
            smem = grid_smem_bytes(t, n, r, g_smem)
            if smem <= smem_optin:
                tiles = -(-m // t)
                return Plan("bcd_grid", tiles, t, False, t, smem, g_smem, grid_scratch_floats(m, n, r, t))
        if t == 1:
            raise ValueError(
                f"the bcd_grid kernel needs {smem} B of shared memory for one row of X (M={m} N={n} R={r}), "
                f"the device has {smem_optin}"
            )
        t //= 2


def _cluster_plan(variant: str, m: int, r: int, smem_optin: int) -> Plan:
    """bcd_cluster.cuh: the smallest cluster whose CTAs hold their X slice
    resident; else the largest cluster, streaming tiles of the largest of
    STREAM_TILES rows that fits."""
    c = 1
    while c <= CLUSTER_MAX:
        s = -(-m // c)
        smem = cluster_smem_bytes(s, s, r)
        if smem <= smem_optin:
            return Plan(variant, c, s, True, s, smem)
        c *= 2
    s = -(-m // CLUSTER_MAX)
    for t in STREAM_TILES:
        smem = cluster_smem_bytes(s, t, r)
        if t < s and smem <= smem_optin:
            return Plan(variant, CLUSTER_MAX, s, False, t, smem)
    smem = cluster_smem_bytes(s, STREAM_TILES[-1], r)
    raise ValueError(f"the {variant} kernel needs {smem} B of shared memory, the device has {smem_optin}")


def cluster_variant(n: int, r: int) -> Optional[str]:
    """The cluster kernel whose ranks hold R at width N, or None."""
    if n != CLUSTER_N:
        return None
    return next((name for name, (lo, hi) in CLUSTER_RANKS.items() if lo <= r <= hi), None)


def launch_plan(m: int, n: int, r: int, smem_optin: int, variant: Optional[str] = None) -> Plan:
    """The kernel and launch geometry for X (M, N) at rank R, from the shape
    alone (never the batch, so an image's result does not depend on it).

    `smem_optin` is the shared memory a block may opt into. `variant`
    forces one kernel (for same-run comparisons); by default the cluster
    kernels take N = 64 with R <= 32 (R <= 16 "bcd_cluster", 17-32
    "bcd_cluster_wide") and bcd_grid.cu the rest. bcd.cu runs only when
    forced.
    """
    if variant is None:
        variant = cluster_variant(n, r) or "bcd_grid"
    if variant == "bcd":
        return _block_plan(m, n, r, smem_optin)
    if variant == "bcd_grid":
        return _grid_plan(m, n, r, smem_optin)
    if variant not in CLUSTER_RANKS:
        raise ValueError(f"unknown bcd kernel {variant!r}")
    lo, hi = CLUSTER_RANKS[variant]
    if n != CLUSTER_N or not lo <= r <= hi:
        raise ValueError(f"the {variant} kernel takes N = {CLUSTER_N} and {lo} <= R <= {hi}; got N={n} R={r}")
    return _cluster_plan(variant, m, r, smem_optin)


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
        self.build_seconds = {}  # source -> seconds from the build's start until its nvcc ended
        self._lib = None  # name -> ctypes.CDLL, once loaded
        self._smem_optin = 0
        self._lock = threading.Lock()

    @property
    def launches(self) -> int:
        """Launches of all kernels together."""
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
        t0 = time.perf_counter()
        procs = {}
        for name, path in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            log = tempfile.TemporaryFile(mode="w+")  # nvcc's output, read once it has ended
            cmd = [nvcc, *NVCC_FLAGS, *self.defines, "-o", tmp, str(CSRC / SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True), tmp, log)
        pending = set(procs)
        while pending:  # each source's own nvcc time, whatever order they end in
            for name in list(pending):
                if procs[name][0].poll() is not None:
                    self.build_seconds[SOURCES[name]] = round(time.perf_counter() - t0, 2)
                    pending.discard(name)
            if pending:
                time.sleep(0.05)
        logs, failed = [], []
        for name, (proc, tmp, log) in procs.items():
            log.seek(0)
            out = log.read()
            log.close()
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
                block = libs["bcd"]
                _bind(block, "lrf_bcd_launch", _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _Z, _P)
                _bind(block, "lrf_bcd_threads", _I)
                _bind(block, "lrf_bcd_smem_optin", _I, ctypes.POINTER(_I))
                _bind(block, "lrf_cuda_error_string", ctypes.c_char_p, _I)
                geometry = [(block.lrf_bcd_threads(), BLOCK_THREADS)]
                grid = libs["bcd_grid"]
                _bind(grid, "lrf_bcdg_launch", _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P)
                _bind(grid, "lrf_bcdg_threads", _I)
                _bind(grid, "lrf_bcdg_smem_bytes", ctypes.c_longlong, _I, _I, _I, _I)
                _bind(grid, "lrf_bcdg_scratch_floats", ctypes.c_longlong, _I, _I, _I, _I)
                _bind(grid, "lrf_cuda_error_string", ctypes.c_char_p, _I)
                geometry.append((grid.lrf_bcdg_threads(), GRID_THREADS))
                # grid_smem_bytes and grid_scratch_floats against the kernel's own
                for m, n, r, t in ((6144, 192, 96, 64), (512, 768, 51, 32), (5, 192, 8, 5), (128, 64, 64, 8)):
                    geometry += [(grid.lrf_bcdg_smem_bytes(t, n, r, g), grid_smem_bytes(t, n, r, bool(g)))
                                 for g in (0, 1)]
                    geometry.append((grid.lrf_bcdg_scratch_floats(m, n, r, t), grid_scratch_floats(m, n, r, t)))
                for name, ranks in CLUSTER_RANKS.items():
                    cluster = libs[name]
                    _bind(cluster, "lrf_bcdc_launch", _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _Z, _P)
                    _bind(cluster, "lrf_bcdc_threads", _I)
                    _bind(cluster, "lrf_bcdc_min_rank", _I)
                    _bind(cluster, "lrf_bcdc_max_rank", _I)
                    _bind(cluster, "lrf_bcdc_max_cluster", _I)
                    _bind(cluster, "lrf_bcdc_smem_bytes", ctypes.c_longlong, _I, _I, _I)
                    _bind(cluster, "lrf_bcdc_max_active_clusters", _I, _I, _I, _Z, ctypes.POINTER(_I))
                    _bind(cluster, "lrf_cuda_error_string", ctypes.c_char_p, _I)
                    geometry += [
                        (cluster.lrf_bcdc_threads(), CLUSTER_THREADS),
                        ((cluster.lrf_bcdc_min_rank(), cluster.lrf_bcdc_max_rank()), ranks),
                        (cluster.lrf_bcdc_max_cluster(), CLUSTER_MAX),
                    ]
                    # cluster_smem_bytes against the kernel's own Layout, resident and streamed
                    geometry += [
                        (cluster.lrf_bcdc_smem_bytes(s, t, r), cluster_smem_bytes(s, t, r))
                        for r in range(ranks[0], ranks[1] + 1) for s, t in ((384, 384), (3072, 128), (6250, 256))
                    ]
                wrong = [(got, want) for got, want in geometry if got != want]
                if wrong:
                    raise RuntimeError(f"kernel geometry (got, want) {wrong} does not match bcd_kernel.py")
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
        """Clusters of `plan` that the device runs at once (cluster kernels only)."""
        lib = self.lib()[plan.variant]
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
        if plan.variant == "bcd_grid":
            lib = libs["bcd_grid"]
            scratch = torch.empty(b * plan.scratch_floats, dtype=torch.float32, device=x.device)
            err = lib.lrf_bcdg_launch(
                x.data_ptr(), u.data_ptr(), v.data_ptr(), scratch.data_ptr(), b, m, n, r, plan.tile, num_iters,
                lo, hi, int(plan.state_in_smem), stream,
            )
        elif plan.variant in CLUSTER_RANKS:
            lib = libs[plan.variant]
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


# Float32 represents every integer of magnitude below 2**24 exactly.
EXACT_LIMIT = 2.0**24


def gs_sum_bound(x, u0, v0, num_iters: int = 10, bounds=(-16, 15)) -> float:
    """The largest magnitude any partial sum of the sweeps can reach, in any
    summation order, along the plain version's path from `(u0, v0)`.

    Per half-sweep it takes the A entries |X| |V| (or |X|^T |U|), the Gram
    entries |V|^T |V|, and each Gauss-Seidel numerator, bounded by |A| +
    max|factor| * (column sum of |Gram|), max|factor| being the larger of
    the bounds and the factor's largest entry. On integer X, once the
    factors are integers, a bound below EXACT_LIMIT makes every sum exact,
    so any two kernels give the same bits. Runs in float64 on x's device.
    """
    project = make_project(bounds)
    lim = max(abs(bounds[0]), abs(bounds[1]))
    xd = x.double()
    u, v = u0.double(), v0.double()
    worst = 0.0
    for _ in range(num_iters):
        for side in (0, 1):
            x_side, f, g = (xd, u, v) if side == 0 else (xd.transpose(-1, -2), v, u)
            a = x_side.abs() @ g.abs()
            gram = g.abs().transpose(-1, -2) @ g.abs()
            dot = max(lim, float(f.abs().max())) * gram.sum(dim=-2)
            worst = max(worst, float(gram.max()), float((a + dot[..., None, :]).max()))
            new = update_columns(x_side @ g, g.transpose(-1, -2) @ g, f, 0.0, 0.0, project)
            u, v = (new, v) if side == 0 else (u, new)
    return worst


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


def qmf_decompose_cuda(
    x: torch.Tensor,
    rank: int,
    num_iters: int = 10,
    bounds: tuple[float, float] = (-16, 15),
    init_method: str = "gram",
):
    """SVD init, then `bcd`: the `factor=(0, 1)` path of
    `lrf_tpu_torch.ops.bcd.qmf_decompose` on `(B, M, N)` batches. Returns
    `(u, v, w)`."""
    x = x.to(torch.float32).contiguous()
    u0, v0, w = svd_init(x, rank, method=init_method, bounds=bounds)
    u, v = bcd(x, u0, v0, num_iters=num_iters, bounds=bounds)
    return u, v, w
