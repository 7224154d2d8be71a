"""The port's array ops against the JAX package's, elementwise on the CPU.

Floats agree within atol 1e-4; index ops (pad, patch, nearest resize) and
casts of one float input agree exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lrf_tpu.ops import color as jcolor
from lrf_tpu.ops import pad as jpad
from lrf_tpu.ops import patch as jpatch
from lrf_tpu.ops.quantize import dtype_range as j_dtype_range, to_dtype as j_to_dtype
from lrf_tpu.ops import resample as jres
from lrf_tpu_torch.ops import color, pad, patch, quantize, resample

RNG = np.random.default_rng(101)
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _image(h, w, batch=()):
    return RNG.integers(0, 256, batch + (3, h, w)).astype(np.uint8)


@pytest.mark.parametrize("batch", [(), (2,)])
def test_color_round_trip_matches_jax(batch):
    img = _image(61, 93, batch)
    y_t = color.rgb_to_ycbcr(_t(img)).numpy()
    y_j = np.asarray(jcolor.rgb_to_ycbcr(jnp.asarray(img)))
    np.testing.assert_allclose(y_t, y_j, atol=ATOL, rtol=0)
    back_t = color.ycbcr_to_rgb(_t(y_j)).numpy()
    back_j = np.asarray(jcolor.ycbcr_to_rgb(jnp.asarray(y_j)))
    np.testing.assert_allclose(back_t, back_j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("size,out", [((64, 96), (32, 48)), ((61, 93), (30, 46)), ((61, 93), (61, 46))])
def test_area_resize_matches_jax(size, out):
    x = RNG.standard_normal((2, 1) + size).astype(np.float32) * 50
    got = resample.area_resize(_t(x), out).numpy()
    want = np.asarray(jres.area_resize(jnp.asarray(x), out))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("size,out", [((32, 48), (64, 96)), ((30, 46), (61, 93)), ((7, 5), (13, 11))])
def test_nearest_resize_matches_jax_exactly(size, out):
    x = RNG.standard_normal((1,) + size).astype(np.float32)
    got = resample.nearest_resize(_t(x), out).numpy()
    want = np.asarray(jres.nearest_resize(jnp.asarray(x), out))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(64, 96), (61, 93), (128, 192)])
def test_chroma_down_and_up_match_jax(size):
    ycc = RNG.uniform(0, 255, (3,) + size).astype(np.float32)
    chans_t = resample.chroma_downsample(_t(ycc), (0.5, 0.5))
    chans_j = jres.chroma_downsample(jnp.asarray(ycc), (0.5, 0.5))
    for a, b in zip(chans_t, chans_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    up_t = resample.chroma_upsample(tuple(_t(np.asarray(c)) for c in chans_j), size).numpy()
    up_j = np.asarray(jres.chroma_upsample(chans_j, size))
    np.testing.assert_array_equal(up_t, up_j)
    assert resample.scaled_size(size, (0.5, 0.5)) == jres.scaled_size(size, (0.5, 0.5))


@pytest.mark.parametrize("size,patch_size", [((61, 93), (8, 8)), ((64, 96), (8, 8)), ((5, 3), (8, 8)), ((30, 46), (8, 8))])
def test_pad_unpad_match_jax_exactly(size, patch_size):
    x = RNG.standard_normal((2, 1) + size).astype(np.float32)
    assert pad.pad_amounts(size, patch_size) == jpad.pad_amounts(size, patch_size)
    got = pad.pad_image(_t(x), patch_size).numpy()
    want = np.asarray(jpad.pad_image(jnp.asarray(x), patch_size))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pad.unpad_image(_t(got), size).numpy(), x)


@pytest.mark.parametrize("shape", [(1, 64, 96), (3, 64, 96), (2, 1, 16, 24)])
def test_patch_round_trip_matches_jax_exactly(shape):
    x = RNG.standard_normal(shape).astype(np.float32)
    got = patch.patchify(_t(x), (8, 8)).numpy()
    want = np.asarray(jpatch.patchify(jnp.asarray(x), (8, 8)))
    np.testing.assert_array_equal(got, want)
    back = patch.depatchify(_t(got), shape[-2:], (8, 8)).numpy()
    np.testing.assert_array_equal(back, np.asarray(jpatch.depatchify(jnp.asarray(want), shape[-2:], (8, 8))))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16])
def test_to_dtype_matches_jax_exactly(dtype):
    x = (RNG.standard_normal((4, 257)) * 200).astype(np.float32)
    x[0, :4] = [-0.5, 0.5, -1.999, 1.999]  # truncation toward zero
    got = quantize.to_dtype(_t(x), dtype).numpy()
    want = np.asarray(j_to_dtype(jnp.asarray(x), dtype))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert quantize.dtype_range(dtype) == tuple(j_dtype_range(dtype))
