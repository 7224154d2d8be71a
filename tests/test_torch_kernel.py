"""The BCD kernel's launch plan and wrapper, and the kernel against its plain
version.

This file imports neither JAX nor `lrf_tpu`, so its `cuda` tests run on a
GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py

On a host without CUDA those tests skip; the plan and wrapper tests run.
"""

import numpy as np
import pytest
import torch

from lrf_tpu_torch.ops import bcd, bcd_kernel

RNG = np.random.default_rng(23)
# The kernel's block size, and the shared memory an H100 block may opt into.
THREADS = 512
H100_SMEM = 232448
SHAPES = [(3, 300, 64, 7), (2, 257, 64, 5), (1, 64, 64, 1), (2, 128, 64, 26), (2, 128, 64, 64)]


@pytest.mark.parametrize(
    "m,n,r,want",
    [
        # bench Y and merged chroma: everything in shared memory, full tiles
        (6144, 64, 6, (512, True, 150816)),
        (1536, 64, 3, (512, True, 140872)),
        (49152, 64, 13, (512, True, 167752)),
        (300, 64, 7, (300, True, 90376)),
        # no-patch and RGB-patch widths: V and the Grams go to global scratch
        (512, 768, 51, (70, False, 229600)),
        (6144, 192, 96, (200, False, 232000)),
    ],
)
def test_launch_plan_at_codec_shapes(m, n, r, want):
    tile, smem_mode, smem = bcd_kernel.launch_plan(m, n, r, THREADS, H100_SMEM)
    assert (tile, smem_mode, smem) == want
    assert 1 <= tile <= min(m, THREADS) and smem <= H100_SMEM


@pytest.mark.parametrize("m", [1, 7, 31, 33])
def test_launch_plan_short_stacks_keep_state_in_shared_memory(m):
    tile, smem_mode, smem = bcd_kernel.launch_plan(m, 64, 1, THREADS, H100_SMEM)
    assert tile == m and smem_mode and smem <= H100_SMEM


def test_launch_plan_rejects_rows_wider_than_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        bcd_kernel.launch_plan(64, H100_SMEM // 4, 3, THREADS, H100_SMEM)


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


@pytest.mark.cuda
# one-patch images (M = 1), rank above min(M, N) (zero-padded init), no-patch width
@pytest.mark.parametrize("b,m,n,r", SHAPES + [(2, 1, 64, 1), (1, 5, 64, 8), (1, 512, 768, 51)])
def test_kernel_matches_plain_on_gpu(b, m, n, r):
    # Tolerance of tests/test_bcd_pallas.py: mean loss within 2e-3 and more
    # than 85% of entries equal (sums run in another order; round() ties flip).
    _cuda()
    x = torch.from_numpy(RNG.integers(0, 256, (b, m, n)).astype(np.float32)).cuda()
    u0, v0, _ = bcd.svd_init(x, r, bounds=(-16, 15))
    before = bcd_kernel.KERNEL.launches
    uk, vk = bcd_kernel.bcd(x, u0, v0, num_iters=4)
    assert bcd_kernel.KERNEL.launches == before + 1
    ur, vr = bcd_kernel.bcd_reference(x, u0, v0, num_iters=4)
    loss_k = float(bcd.qmf_loss(x, uk, vk).mean())
    loss_r = float(bcd.qmf_loss(x, ur, vr).mean())
    assert abs(loss_k - loss_r) < 2e-3
    assert float((uk == ur).float().mean()) > 0.85 and float((vk == vr).float().mean()) > 0.85
    for f in (uk, vk):
        assert torch.all(f == torch.round(f)) and f.min() >= -16 and f.max() <= 15
    u1, v1 = bcd_kernel.bcd(x[:1].contiguous(), u0[:1], v0[:1], num_iters=4)
    assert torch.equal(uk[:1], u1) and torch.equal(vk[:1], v1)


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
