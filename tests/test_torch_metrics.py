"""The port's quality and rate metrics against the JAX package's.

Same numpy-seeded inputs (crops of the repo's PNGs with seeded noise, and
pure seeded noise) through `lrf_tpu.utils.metrics` and
`lrf_tpu_torch.utils.metrics`: SSIM within 1e-5 absolute; the rates and
byte counts equal; mae, mse, relative_error and psnr within rtol 1e-6 of
the same formula in float64, and within rtol 2e-5 of the JAX package's,
whose float32 sums on the CPU are off from float64 by up to 1.2e-5 relative
on these inputs (torch's by under 1e-7). The `cuda` case holds SSIM and
PSNR on the card to the CPU's:

    python -m pytest --noconftest -m cuda tests/test_torch_metrics.py
"""

import numpy as np
import pytest
import torch

import lrf_tpu_torch as lt
from lrf_tpu_torch.utils import metrics as tm
from torch_images import kodim01, photos


def _pairs():
    rng = np.random.default_rng(31)
    img = np.ascontiguousarray(kodim01()[:, 100:196, 200:328])
    noisy = np.clip(img.astype(np.int16) + rng.integers(-9, 10, img.shape), 0, 255).astype(np.uint8)
    flat = np.full((3, 40, 56), 128, np.uint8)
    return {
        "kodim01 + noise": (img, noisy),
        "local7 crops": tuple(photos(2, 64, 80, seed=3)),
        "seeded noise": tuple(rng.integers(0, 256, (2, 3, 33, 47)).astype(np.uint8)),
        "float noise": tuple(rng.standard_normal((2, 1, 24, 24)).astype(np.float32)),
        "flat vs noise": (flat, rng.integers(120, 136, flat.shape).astype(np.uint8)),
    }


PAIRS = _pairs()


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_reductions_match_jax(name):
    from lrf_tpu.utils import metrics as jm

    a, b = PAIRS[name]
    x, y = a.astype(np.float64), b.astype(np.float64)
    exact = {
        "mae": np.abs(x - y).mean(),
        "mse": ((x - y) ** 2).mean(),
        "relative_error": np.sqrt(((x - y) ** 2).sum()) / np.sqrt((x**2).sum()),
        "psnr": 20 * np.log10(255.0 / np.sqrt(((x - y) ** 2).mean())),
    }
    for fn, want in exact.items():
        got = float(getattr(tm, fn)(a, b))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=fn)
        np.testing.assert_allclose(got, float(getattr(jm, fn)(a, b)), rtol=2e-5, err_msg=fn)
    batched = np.stack([a, b])
    np.testing.assert_allclose(tm.mae(batched, batched[::-1]).numpy(), np.abs(x - y).mean(axis=(-3, -2, -1)),
                               rtol=1e-6)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_ssim_matches_jax(name):
    from lrf_tpu.utils import metrics as jm

    a, b = PAIRS[name]
    got = tm.ssim(a, b)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(jm.ssim(a, b)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tm.ssim(torch.from_numpy(a), b)), float(got), atol=0, rtol=0)
    if a.max() > a.min():  # a flat first image has no data range
        assert abs(float(tm.ssim(a, a)) - 1.0) < 1e-6


def test_rates_and_memory_match_jax():
    from lrf_tpu.utils import metrics as jm

    img = PAIRS["kodim01 + noise"][0]
    stream = lt.qmf_encode(img, quality=10, device="cpu")
    objs = [
        stream,
        [stream, stream[:7]],
        {"u": np.zeros((5, 3), np.int8), "v": torch.zeros(4, 2, dtype=torch.float32)},
        (b"abc", (np.ones(9, np.float64),), {torch.ones(3, dtype=torch.int16).numpy().tobytes()}),
    ]
    for obj in objs:
        assert tm.get_memory_usage(obj) == jm.get_memory_usage(obj)
        np.testing.assert_allclose(tm.compression_ratio(img, obj), jm.compression_ratio(img, obj), rtol=1e-6)
        np.testing.assert_allclose(tm.bits_per_pixel(img.shape[-2:], obj), jm.bits_per_pixel(img.shape[-2:], obj),
                                   rtol=1e-6)
    assert tm.get_memory_usage(torch.zeros(2, 3, dtype=torch.float64)) == 48
    with pytest.raises(ValueError, match="Unsupported"):
        tm.get_memory_usage("a string")


@pytest.mark.cuda
def test_ssim_and_psnr_on_gpu_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, (a, b) in PAIRS.items():
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        for fn in (tm.ssim, tm.psnr):
            on_card = fn(ta.cuda(), tb.cuda())
            assert on_card.device.type == "cuda"
            np.testing.assert_allclose(float(on_card), float(fn(ta, tb)), rtol=1e-5, atol=1e-6, err_msg=name)
