"""The port's codec step and sharded dry run against the JAX package's
`__graft_entry__.py`, on the CPU.

- `entry(device="cpu")`: the same seeded (3, 512, 768) uint8 image; six
  int8 factors of the JAX package's shapes, within the bounds (-16, 15).
  The image is uniform noise, where the integer sweeps are most sensitive
  to their start: from the two packages' inits, which differ in their last
  bits, more than 75% of each factor's entries are equal (measured 78.0-
  92.6%), and each channel's residual |X - U V^T| is within 1e-3
  (relative) of the JAX package's (measured 2e-5 to 5.3e-5).
- `dryrun_multichip(2, devices=["cpu"] * 2)` runs its three checks; with no
  devices given and no CUDA it raises.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from lrf_tpu_torch import entry as port_entry
from lrf_tpu_torch.ops.color import rgb_to_ycbcr
from lrf_tpu_torch.ops.pad import pad_image
from lrf_tpu_torch.ops.patch import patchify
from lrf_tpu_torch.ops.resample import chroma_downsample


@pytest.fixture(scope="module")
def both():
    import jax

    fj, (ij,) = jax_entry.entry()
    ft, (it,) = port_entry.entry(device="cpu")
    return np.asarray(ij), [np.asarray(a) for a in jax.jit(fj)(ij)], it, ft(it)


def test_entry_image_and_factors(both):
    image_j, out_j, image_t, out_t = both
    assert image_t.dtype == torch.uint8 and tuple(image_t.shape) == (3, 512, 768) and image_t.device.type == "cpu"
    np.testing.assert_array_equal(image_t.numpy(), image_j)
    assert len(out_t) == len(out_j) == 6
    for a, b in zip(out_j, out_t):
        assert b.dtype == torch.int8 and tuple(b.shape) == a.shape
        assert int(b.min()) >= -16 and int(b.max()) <= 15
    ranks = [out_t[i].shape[-1] for i in (0, 2, 4)]
    assert tuple(ranks) == port_entry.RANKS == (13, 6, 6)


def test_entry_factors_match_jax(both):
    image_j, out_j, image_t, out_t = both
    channels = chroma_downsample(rgb_to_ycbcr(image_t.to(torch.float32)), (0.5, 0.5))
    for c, channel in enumerate(channels):
        x = patchify(pad_image(channel, (8, 8)), (8, 8)).double().numpy()
        uj, vj = (out_j[2 * c + k].astype(np.float64) for k in (0, 1))
        ut, vt = (out_t[2 * c + k].numpy().astype(np.float64) for k in (0, 1))
        assert (uj == ut).mean() > 0.75 and (vj == vt).mean() > 0.75, c
        res_j = np.linalg.norm(x - uj @ vj.T)
        res_t = np.linalg.norm(x - ut @ vt.T)
        assert abs(res_t - res_j) <= 1e-3 * res_j, (c, res_t, res_j)


def test_dryrun_multichip_on_cpu_devices():
    port_entry.dryrun_multichip(2, devices=["cpu"] * 2)
    port_entry.dryrun_multichip(1, devices=["cpu"])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal path needs a host without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.dryrun_multichip(2)


@pytest.mark.cuda
def test_entry_on_gpu_launches_the_cluster_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lrf_tpu_torch.ops import bcd_kernel as bk

    forward, (image,) = port_entry.entry()
    assert image.is_cuda
    for name in bk.KERNEL.counts:
        bk.KERNEL.counts[name] = 0
    out = forward(image)
    torch.cuda.synchronize()
    assert dict(bk.KERNEL.counts) == {name: 3 if name == "bcd_cluster" else 0 for name in bk.KERNEL.counts}
    assert all(f.dtype == torch.int8 and f.is_cuda for f in out)
