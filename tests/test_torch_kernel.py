"""The BCD kernel's launch plan and wrapper, and the kernel against its plain
version.

This file imports neither JAX nor `lrf_tpu`, so its `cuda` tests run on a
GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py

On a host without CUDA those tests skip; the plan and wrapper tests run.
"""

import shutil

import numpy as np
import pytest
import torch

from lrf_tpu_torch.ops import bcd, bcd_kernel, deflate

RNG = np.random.default_rng(23)
# The shared memory an H100 block may opt into.
H100_SMEM = 232448
SHAPES = [(3, 300, 64, 7), (2, 257, 64, 5), (1, 64, 64, 1), (2, 128, 64, 26), (2, 128, 64, 64),
          (2, 257, 64, 17), (2, 128, 64, 32)]
# The grid kernel's regimes: N = 64 at R > 32, RGB patches at q50 (N = 192,
# 19 tiles of 16 rows), and rank above M.
GRID_SHAPES = [(2, 128, 64, 40), (1, 300, 192, 96), (1, 5, 192, 8)]
# Float YCbCr-like X at a resident cluster (C = 2), a streamed one (16 CTAs),
# the q40 Y stack of a per-image encode (16 CTAs, wide ranks, resident) and
# the q75 one (the grid kernel, 96 CTAs).
FLOAT_X_SHAPES = [(3, 1000, 64, 6), (2, 20000, 64, 4), (1, 6144, 64, 26), (1, 6144, 64, 48)]
EXACT_LIMIT = bcd_kernel.EXACT_LIMIT


@pytest.mark.parametrize(
    "m,n,r,want",
    [
        # bench Y and merged chroma: a cluster per image, X slices resident
        (6144, 64, 6, ("bcd_cluster", 8, 768, True, 768, 227600)),
        (1536, 64, 3, ("bcd_cluster", 2, 768, True, 768, 212080)),
        # CLIC-size Y: the largest cluster, X streamed in 256-row tiles
        (49152, 64, 13, ("bcd_cluster", 16, 3072, False, 256, 187440)),
        (300, 64, 7, ("bcd_cluster", 1, 300, True, 300, 99552)),
        # ranks 17-32 at N = 64: the wide cluster kernel; the q40 Y stack
        # resident in 16 CTAs, R = 32 streamed in 128-row tiles
        (128, 64, 26, ("bcd_cluster_wide", 1, 128, True, 128, 113136)),
        (6144, 64, 26, ("bcd_cluster_wide", 16, 384, True, 384, 207344)),
        (6144, 64, 32, ("bcd_cluster_wide", 16, 384, False, 128, 184320)),
        # rank above the cluster kernels' 32: the grid kernel, 64-row tiles
        (6144, 64, 33, ("bcd_grid", 96, 64, False, 64, 46084)),
        # no-patch width: 32-row tiles so that one image fills 16 CTAs
        (512, 768, 51, ("bcd_grid", 16, 32, False, 32, 130084)),
        # RGB patches at q50: 96 CTAs per image
        (6144, 192, 96, ("bcd_grid", 96, 64, False, 64, 144128)),
    ],
)
def test_launch_plan_at_codec_shapes(m, n, r, want):
    plan = bcd_kernel.launch_plan(m, n, r, H100_SMEM)
    assert (plan.variant, plan.cluster, plan.rows_per_cta, plan.resident, plan.tile, plan.smem_bytes) == want
    assert plan.smem_bytes <= H100_SMEM
    assert plan.cluster * plan.rows_per_cta >= m > (plan.cluster - 1) * plan.rows_per_cta
    # V^T V sits beside the tile at every codec shape (bcd_grid), or the
    # cluster kernels keep their state in shared memory
    assert plan.state_in_smem


@pytest.mark.parametrize("m", [1, 7, 31, 33])
def test_launch_plan_short_stacks_keep_state_in_shared_memory(m):
    plan = bcd_kernel.launch_plan(m, 64, 1, H100_SMEM)
    assert plan.variant == "bcd_cluster" and plan.cluster == 1 and plan.rows_per_cta == m
    assert plan.resident and plan.state_in_smem and plan.smem_bytes <= H100_SMEM
    old = bcd_kernel.launch_plan(m, 64, 1, H100_SMEM, variant="bcd")
    assert old.tile == m and old.state_in_smem and old.smem_bytes <= H100_SMEM


@pytest.mark.parametrize(
    "m,r",
    [(6144, 6), (1536, 3), (49152, 13), (6144, 16), (100000, 16), (6144, 26)]
    + [(m, r) for r in (17, 32) for m in (1, 33, 384, 6144, 49152, 100000)],
)
def test_cluster_plan_covers_m_and_fits(m, r):
    # The smallest cluster that keeps X resident, else 16 CTAs streaming
    # the largest tile that fits; the bytes are the kernel's Layout.
    plan = bcd_kernel.launch_plan(m, 64, r, H100_SMEM)
    assert plan.variant == ("bcd_cluster" if r <= 16 else "bcd_cluster_wide") and plan.smem_bytes <= H100_SMEM
    assert plan.smem_bytes == bcd_kernel.cluster_smem_bytes(plan.rows_per_cta, plan.tile, r)
    assert plan.cluster * plan.rows_per_cta >= m > (plan.cluster - 1) * plan.rows_per_cta
    if plan.resident:
        assert plan.tile == plan.rows_per_cta
        if plan.cluster > 1:
            half = -(-m // (plan.cluster // 2))
            assert bcd_kernel.cluster_smem_bytes(half, half, r) > H100_SMEM
    else:
        assert plan.cluster == bcd_kernel.CLUSTER_MAX
        assert bcd_kernel.cluster_smem_bytes(plan.rows_per_cta, plan.rows_per_cta, r) > H100_SMEM
        fits = [t for t in bcd_kernel.STREAM_TILES
                if t < plan.rows_per_cta and bcd_kernel.cluster_smem_bytes(plan.rows_per_cta, t, r) <= H100_SMEM]
        assert plan.tile == fits[0] <= bcd_kernel.CLUSTER_THREADS


def test_launch_plan_forced_variants():
    assert bcd_kernel.launch_plan(6144, 64, 6, H100_SMEM, variant="bcd").variant == "bcd"
    assert bcd_kernel.launch_plan(6144, 64, 26, H100_SMEM, variant="bcd").variant == "bcd"
    with pytest.raises(ValueError, match="N = 64"):
        bcd_kernel.launch_plan(512, 768, 51, H100_SMEM, variant="bcd_cluster")
    for variant, r in (("bcd_cluster", 33), ("bcd_cluster", 17), ("bcd_cluster_wide", 16), ("bcd_cluster_wide", 33)):
        with pytest.raises(ValueError, match="<= R <="):
            bcd_kernel.launch_plan(6144, 64, r, H100_SMEM, variant=variant)
    with pytest.raises(ValueError, match="unknown"):
        bcd_kernel.launch_plan(64, 64, 1, H100_SMEM, variant="nope")


@pytest.mark.parametrize(
    "n,r,want",
    [(64, 1, "bcd_cluster"), (64, 16, "bcd_cluster"), (64, 17, "bcd_cluster_wide"), (64, 32, "bcd_cluster_wide"),
     (64, 33, "bcd_grid"), (64, 64, "bcd_grid"), (192, 8, "bcd_grid"), (192, 17, "bcd_grid"),
     (768, 26, "bcd_grid")],
)
def test_launch_plan_routes_by_width_and_rank(n, r, want):
    # N = 64 with R <= 32 takes a cluster kernel; every other shape the grid
    # kernel; bcd.cu only when forced
    assert bcd_kernel.launch_plan(384, n, r, H100_SMEM).variant == want
    assert bcd_kernel.cluster_variant(n, r) == (None if want == "bcd_grid" else want)


def test_launch_plan_rejects_rows_wider_than_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        bcd_kernel.launch_plan(64, H100_SMEM // 4, 3, H100_SMEM)


@pytest.mark.parametrize("variant", [None, "bcd_grid", "bcd"])
def test_rows_wider_than_shared_memory_raise_naming_the_shape(variant):
    # N = 58,200: one row of X alone is 232,800 B, above the 232,448 B a block may use
    with pytest.raises(ValueError, match=r"shared memory.*N=58200 R=3|N=58200 R=3.*shared memory"):
        bcd_kernel.launch_plan(64, 58200, 3, H100_SMEM, variant=variant)


@pytest.mark.parametrize(
    "m,n,r",
    [(6144, 64, 48), (6144, 64, 64), (6144, 192, 19), (6144, 192, 96), (512, 768, 51), (256, 384, 13),
     (512, 768, 256), (128, 64, 64), (300, 192, 96), (5, 192, 8), (1, 64, 40), (49152, 192, 96)],
)
def test_grid_plan_tiles_come_from_the_shape_and_fill_the_card(m, n, r):
    # The tile height and CTA count are functions of (M, N, R): the plan
    # takes no batch. Tiles of at most 64 rows, halved down to 8 while one
    # image would fill fewer than 16 CTAs; the U phase's shared memory is
    # grid_smem_bytes; the scratch is each tile's partials plus their sums
    # and V^T V.
    plan = bcd_kernel.launch_plan(m, n, r, H100_SMEM)
    assert plan.variant == "bcd_grid" and plan.tile == plan.rows_per_cta
    assert plan == bcd_kernel.launch_plan(m, n, r, H100_SMEM, variant="bcd_grid")
    t = plan.tile
    assert 1 <= t <= bcd_kernel.GRID_TILE and plan.cluster == -(-m // t)
    if t >= bcd_kernel.GRID_MIN_TILE and t < min(m, bcd_kernel.GRID_TILE):
        assert -(-m // (2 * t)) < bcd_kernel.GRID_MIN_CTAS
    if m >= bcd_kernel.GRID_MIN_TILE * bcd_kernel.GRID_MIN_CTAS:
        assert plan.cluster >= bcd_kernel.GRID_MIN_CTAS
    assert plan.smem_bytes == bcd_kernel.grid_smem_bytes(t, n, r, plan.state_in_smem) <= H100_SMEM
    assert plan.scratch_floats == plan.cluster * (n * r + r * r) + (n * r + r * r) + r * r


def test_grid_plan_keeps_v_gram_off_shared_memory_when_it_does_not_fit():
    # no-patch q50: V^T V (256 KB) cannot sit beside a 32-row tile
    plan = bcd_kernel.launch_plan(512, 768, 256, H100_SMEM)
    assert (plan.variant, plan.tile, plan.cluster, plan.state_in_smem) == ("bcd_grid", 32, 16, False)
    assert bcd_kernel.grid_smem_bytes(32, 768, 256, True) > H100_SMEM
    # a small budget shortens the tile instead of failing
    small = bcd_kernel.grid_smem_bytes(4, 768, 256, False)
    plan = bcd_kernel.launch_plan(512, 768, 256, small)
    assert (plan.tile, plan.cluster, plan.smem_bytes) == (4, 128, small)


def test_grid_scratch_bytes_of_the_batched_q75_y_stack():
    # (64, 6144, 64, 48): 96 tiles per image, each with a 64 x 48 X^T U and
    # a 48 x 48 U^T U partial, plus their sums and V^T V, for 64 images
    plan = bcd_kernel.launch_plan(6144, 64, 48, H100_SMEM)
    assert (plan.tile, plan.cluster) == (64, 96)
    assert plan.scratch_floats == 96 * 5376 + 5376 + 2304 == 523776
    assert 64 * plan.scratch_floats * 4 == 134086656


def test_launch_plan_forced_block_kernel_still_plans():
    # bcd.cu runs only when forced; its plan is one block per image
    for m, n, r, state in ((6144, 64, 33, True), (512, 768, 51, False), (6144, 192, 96, False), (128, 64, 64, True)):
        plan = bcd_kernel.launch_plan(m, n, r, H100_SMEM, variant="bcd")
        assert (plan.variant, plan.cluster, plan.rows_per_cta, plan.state_in_smem) == ("bcd", 1, m, state)
        assert plan.smem_bytes <= H100_SMEM and 1 <= plan.tile <= bcd_kernel.BLOCK_THREADS
        assert bcd_kernel.launch_plan(m, n, r, H100_SMEM).variant == "bcd_grid"


def test_library_path_covers_every_file_under_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(bcd_kernel.CSRC, csrc)
    monkeypatch.setattr(bcd_kernel, "CSRC", csrc)
    lib = bcd_kernel._KernelLib()
    paths = {lib.library_path(name) for name in bcd_kernel.SOURCES}
    assert len(paths) == len(bcd_kernel.SOURCES)
    # the DEFLATE kernel's sources (`deflate*`) build a library of their own
    # (`ops/deflate.py`), whose path hashes them instead
    files = sorted(p for p in csrc.iterdir() if p.is_file() and not p.name.startswith("deflate"))
    own = sorted(p for p in csrc.iterdir() if p.is_file() and p.name.startswith("deflate"))
    assert {f.name for f in files} >= set(bcd_kernel.SOURCES.values())
    assert {f.name for f in own} == {"deflate.cu", "deflate_core.h"}
    seen = {lib.digest()}
    for f in files:  # an edit of any source or header
        f.write_bytes(f.read_bytes() + b"\n// edited\n")
        seen.add(lib.digest())
    (csrc / "common.cuh").write_text("// a new header\n")
    seen.add(lib.digest())
    before = lib.digest()
    monkeypatch.setattr(deflate, "SOURCE", csrc / "deflate.cu")
    monkeypatch.setattr(deflate, "CORE", csrc / "deflate_core.h")
    deflate_paths = {deflate.KERNEL.library_path()}
    for f in own:
        f.write_bytes(f.read_bytes() + b"\n// edited\n")
        deflate_paths.add(deflate.KERNEL.library_path())
    assert lib.digest() == before and len(deflate_paths) == len(own) + 1
    monkeypatch.setattr(bcd_kernel, "NVCC_FLAGS", bcd_kernel.NVCC_FLAGS + ("-lineinfo",))
    seen.add(lib.digest())
    assert len(seen) == len(files) + 3
    assert all(lib.library_path(name).name.endswith(f"_{lib.digest()}.so") for name in bcd_kernel.SOURCES)


def _fake_nvcc(tmp_path, slow: str, fail: str = "") -> str:
    # writes "built <source>" to its -o file, after a second for `slow`;
    # exits 1 for `fail`
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        'out=""; src=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; src="$a"; prev="$a"; done\n'
        'echo "ptxas info    : compiling $src"\n'
        f'case "$src" in *{fail or "@none@"}) exit 1;; esac\n'
        f'case "$src" in *{slow}) sleep 1;; esac\n'
        'echo "built $src" > "$out"\n'
    )
    script.chmod(0o755)
    return str(script)


def test_build_times_each_nvcc_on_its_own(tmp_path, monkeypatch):
    # all sources build at once; a fast source's time is its own even when
    # a slow one was started before it, and every log is kept
    monkeypatch.setattr(bcd_kernel, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(bcd_kernel, "_find_nvcc", lambda: _fake_nvcc(tmp_path, "/bcd_cluster_wide.cu"))
    lib = bcd_kernel._KernelLib()
    paths = lib.build()
    assert set(paths) == set(bcd_kernel.SOURCES)
    for name, path in paths.items():
        assert path.read_text().strip().endswith(bcd_kernel.SOURCES[name])
        assert f"== {bcd_kernel.SOURCES[name]}\nptxas info" in lib.build_log
    seconds = lib.build_seconds
    assert seconds["bcd_cluster_wide.cu"] >= 1.0 > seconds["bcd_grid.cu"]
    assert max(seconds["bcd.cu"], seconds["bcd_cluster.cu"]) < 1.0
    assert lib.build() == paths  # built: nothing to do


def test_build_raises_naming_the_failed_source(tmp_path, monkeypatch):
    monkeypatch.setattr(bcd_kernel, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(bcd_kernel, "_find_nvcc", lambda: _fake_nvcc(tmp_path, "@none@", fail="/bcd_grid.cu"))
    lib = bcd_kernel._KernelLib()
    with pytest.raises(RuntimeError, match=r"nvcc failed: bcd_grid.cu \(1\)"):
        lib.build()
    assert not lib.library_path("bcd_grid").exists() and lib.library_path("bcd").exists()
    assert not [p for p in (tmp_path / "build").iterdir() if p.name.startswith("tmp")]


def test_extra_defines_build_a_library_of_their_own():
    plain, profiled = bcd_kernel._KernelLib(), bcd_kernel._KernelLib(defines=("-DLRF_BCDC_PROFILE",))
    for name in bcd_kernel.SOURCES:
        assert plain.library_path(name) != profiled.library_path(name)
    assert plain.library_path() == bcd_kernel.KERNEL.library_path()


def test_phase_tool_refuses_to_run_without_cuda(monkeypatch, tmp_path):
    from lrf_tpu_torch.tools import bcd_kernel_phases

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "phases.json"
    assert bcd_kernel_phases.main(["--out", str(out)]) == 1
    assert not out.exists()


def test_grid_phase_tool_refuses_to_run_without_cuda(monkeypatch, tmp_path):
    from lrf_tpu_torch.tools import bcd_grid_phases

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "phases.json"
    assert bcd_grid_phases.main(["--out", str(out)]) == 1
    assert not out.exists()


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(2, 64, 64)
    u, v = torch.zeros(2, 64, 3), torch.zeros(2, 64, 3)
    with pytest.raises(ValueError, match="num_iters"):
        bcd_kernel.bcd(x, u, v, num_iters=-1)
    with pytest.raises(ValueError, match="do not fit"):
        bcd_kernel.bcd(x, u[:, :63], v)
    with pytest.raises(ValueError, match="meta"):
        bcd_kernel.bcd(x.to("meta"), u.to("meta"), v.to("meta"))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the BCD kernel has no CPU mode)")


def _stack(kind, b, m, n):
    if kind == "int":
        return torch.from_numpy(RNG.integers(0, 256, (b, m, n)).astype(np.float32))
    # YCbCr-like float planes: a smooth field plus noise, inside [16, 235].
    base = RNG.uniform(40.0, 200.0, (b, 1, n)) + RNG.normal(0.0, 12.0, (b, m, n))
    return torch.from_numpy(np.clip(base, 16.0, 235.0).astype(np.float32))


def test_gs_sum_bound_covers_the_sums_it_reckons():
    # the bound is at least every A entry and Gram entry of the first sweep,
    # and grows with M (X^T U and U^T U sum over the rows)
    x = torch.from_numpy(RNG.integers(0, 256, (1, 96, 64)).astype(np.float32))
    u0, v0, _ = bcd.svd_init(x, 8, bounds=(-16, 15))
    bound = bcd_kernel.gs_sum_bound(x, u0, v0, 1)
    assert bound >= float((x @ v0).abs().max()) and bound >= float((v0.transpose(-1, -2) @ v0).abs().max())
    assert bound < EXACT_LIMIT
    tall = torch.cat([x] * 64, dim=1)
    assert bcd_kernel.gs_sum_bound(tall, torch.cat([u0] * 64, dim=1), v0, 1) > bound


def _matches_plain(x, r, exact=False):
    # Tolerance of tests/test_bcd_pallas.py: mean loss within 2e-3 and more
    # than 85% of entries equal (sums run in another order; round() ties flip).
    # `exact`: the factors must be equal (integer X, every sum an exact integer).
    b, m, n = x.shape
    u0, v0, _ = bcd.svd_init(x, r, bounds=(-16, 15))
    plan = bcd_kernel.KERNEL.plan(m, n, r)
    before = dict(bcd_kernel.KERNEL.counts)
    uk, vk = bcd_kernel.bcd(x, u0, v0, num_iters=4)
    assert bcd_kernel.KERNEL.counts[plan.variant] == before[plan.variant] + 1
    assert bcd_kernel.KERNEL.launches == sum(before.values()) + 1
    ur, vr = bcd_kernel.bcd_reference(x, u0, v0, num_iters=4)
    loss_k = float(bcd.qmf_loss(x, uk, vk).mean())
    loss_r = float(bcd.qmf_loss(x, ur, vr).mean())
    assert abs(loss_k - loss_r) < 2e-3
    assert float((uk == ur).float().mean()) > 0.85 and float((vk == vr).float().mean()) > 0.85
    if exact:
        assert torch.equal(uk, ur) and torch.equal(vk, vr)
    for f in (uk, vk):
        assert torch.all(f == torch.round(f)) and f.min() >= -16 and f.max() <= 15
    u1, v1 = bcd_kernel.bcd(x[:1].contiguous(), u0[:1], v0[:1], num_iters=4)
    assert torch.equal(uk[:1], u1) and torch.equal(vk[:1], v1)


@pytest.mark.cuda
# one-patch images (M = 1), rank above min(M, N) (zero-padded init), no-patch width
@pytest.mark.parametrize(
    "b,m,n,r", SHAPES + [(2, 1, 64, 1), (1, 5, 64, 8), (1, 512, 768, 51)] + GRID_SHAPES + FLOAT_X_SHAPES
)
def test_kernel_matches_plain_on_gpu(b, m, n, r):
    _cuda()
    kind = "float" if (b, m, n, r) in FLOAT_X_SHAPES else "int"
    x = _stack(kind, b, m, n).cuda()
    # bit-equal on integer X where a cluster kernel runs (bcd.cu's sums pass 2**24 at R = 64)
    _matches_plain(x, r, exact=kind == "int" and bcd_kernel.cluster_variant(n, r) is not None)
    if kind == "int":
        _exact_from_integer_init(x, r)


def _exact_from_integer_init(x, r):
    # From the svd init projected to integers, every sum of the 4 sweeps on
    # integer X is an exact integer while its magnitude stays below 2**24:
    # there the planned kernel, whatever its order, must give the plain
    # version's bits. bcd_kernel.gs_sum_bound reckons the largest partial
    # sum along the plain path; at these test shapes it stays below 2**24.
    # (From the float init itself the first sweep's sums are not integers,
    # so a last-bit difference may flip a rounding there.)
    u0, v0, _ = bcd.svd_init(x, r, bounds=(-16, 15))
    ui, vi = torch.clamp(torch.round(u0), -16, 15), torch.clamp(torch.round(v0), -16, 15)
    assert bcd_kernel.gs_sum_bound(x, ui, vi, 4) < EXACT_LIMIT
    uk, vk = bcd_kernel.bcd(x, ui, vi, num_iters=4)
    ur, vr = bcd_kernel.bcd_reference(x, ui, vi, num_iters=4)
    assert torch.equal(uk, ur) and torch.equal(vk, vr)


@pytest.mark.cuda
def test_cluster_layout_matches_plan_bytes_on_gpu():
    # cluster_smem_bytes is the kernels' Layout at every rank, resident and streamed
    _cuda()
    libs = bcd_kernel.KERNEL.lib()
    for name, (lo, hi) in bcd_kernel.CLUSTER_RANKS.items():
        for r in range(lo, hi + 1):
            for s, t in ((1, 1), (33, 33), (384, 384), (384, 128), (3072, 256), (6250, 64)):
                got = libs[name].lrf_bcdc_smem_bytes(s, t, r)
                assert got == bcd_kernel.cluster_smem_bytes(s, t, r), (name, s, t, r)


@pytest.mark.cuda
def test_kernel_zero_iters_and_bad_inputs_on_gpu():
    _cuda()
    x = torch.from_numpy(RNG.integers(0, 256, (2, 96, 64)).astype(np.float32)).cuda()
    u0, v0, _ = bcd.svd_init(x, 4, bounds=(-16, 15))
    before = bcd_kernel.KERNEL.launches
    u, v = bcd_kernel.bcd(x, u0, v0, num_iters=0)
    assert bcd_kernel.KERNEL.launches == before
    assert torch.equal(u, u0) and torch.equal(v, v0)
    with pytest.raises(ValueError, match="contiguous float32"):
        bcd_kernel.bcd(x.double(), u0, v0)
    with pytest.raises(ValueError, match="contiguous float32"):
        bcd_kernel.bcd(x.transpose(-1, -2).contiguous().transpose(-1, -2), u0, v0)
    with pytest.raises(ValueError, match="several devices"):
        bcd_kernel.bcd(x, u0.cpu(), v0)
