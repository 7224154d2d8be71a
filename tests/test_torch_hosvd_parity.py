"""The port's HOSVD codecs against the JAX package's at the size of a
photograph, on the CPU: the seven `experiments/data/local7` PNGs, each
cropped to its top-left 512x768 (or kept whole where smaller), through
`hosvd_encode` at com_ratio 50 and `patch_hosvd_encode` at bpp 0.5, each
package decoding its own dict.

The codecs' quantizers truncate, so the factors' column signs move PSNR;
the port takes each mode Gram's eigh through LAPACK's `?syevd` on the host,
as the JAX package's CPU `eigh` does (`lrf_tpu_torch/ops/svd.py::
_lapack_eigh`). Each PSNR gap (port - JAX) must be within 0.1 dB, except on
one image, named in `RESIDUAL` with its reading, which must be within 1 dB:
there the two packages' Grams differ in their last bits, and that flips
LAPACK's sign choice in 2 columns of the whole-image codec's mode 1 (ROADMAP
queue 3). With `torch.linalg.eigh` the patch codec read -2.0489 dB on
parrots_recon_a.png and -1.5641 on clic_flower_fig.png.

About 35 s on one core of this host, most of it the JAX compiles of the
four image sizes.
"""

import glob
import os

import numpy as np
import pytest

import lrf_tpu
import lrf_tpu_torch

import torch_images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = sorted(glob.glob(os.path.join(ROOT, "experiments", "data", "local7", "*.png")))
CODECS = {
    "hosvd": ("hosvd_encode", "hosvd_decode", dict(com_ratio=50)),
    "patch hosvd": ("patch_hosvd_encode", "patch_hosvd_decode", dict(bpp=0.5)),
}
# The one image held to 1 dB, with its gaps (port - JAX) on this host.
RESIDUAL = {"parrots_recon_b.png": {"hosvd": +0.7775, "patch hosvd": -0.2974}}
BOUND_DB, RESIDUAL_DB = 0.1, 1.0


def _psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10 * np.log10(255.0**2 / mse))


def test_seven_images():
    assert [os.path.basename(p) for p in PATHS] == [
        "china.png", "clic_flower_fig.png", "flower.png", "grace_hopper.png", "kodim01_fig.png",
        "parrots_recon_a.png", "parrots_recon_b.png"]
    assert len(RESIDUAL) <= 1


@pytest.mark.parametrize("path", PATHS, ids=os.path.basename)
def test_psnr_gap_to_jax(path):
    img = np.ascontiguousarray(torch_images.load(path)[:, :512, :768])
    name = os.path.basename(path)
    gaps = {}
    for codec, (enc, dec, kw) in CODECS.items():
        x_port = getattr(lrf_tpu_torch, dec)(getattr(lrf_tpu_torch, enc)(img, device="cpu", **kw), device="cpu")
        x_jax = np.asarray(getattr(lrf_tpu, dec)(getattr(lrf_tpu, enc)(img, **kw)))
        gaps[codec] = _psnr(img, x_port) - _psnr(img, x_jax)
    bound = RESIDUAL_DB if name in RESIDUAL else BOUND_DB
    assert all(abs(g) < bound for g in gaps.values()), (name, gaps, bound)
