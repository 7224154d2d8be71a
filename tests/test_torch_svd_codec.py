"""The port's quantization, SVD codec and PIL baseline against the JAX
package's, on the CPU.

- `quantize`, `dequantize` and `np_dequantize` equal the JAX package's bit
  for bit (float32 min, max and scale; truncating cast; `dequantize`
  subtracts the observed `q.min()`, not `qmin`).
- The SVD codec's rank helpers are equal and its metadata has the same
  keys, ranks and sizes.
- Cross-decode: each package decodes the other's streams, in both color
  spaces, with and without patches; decoded pixels of one stream differ
  between the packages by at most 1, in under 0.1% of pixels.
- Float-factor streams (`dtype=np.float32`) are sign-free: the port's
  decodes to the JAX package's pixels within the same +-1 contract.
- Quantized streams depend on the solver's singular-vector signs: one
  `(scale, min)` quantizes all of U with a truncating cast, so the sign of a
  component moves its rounding error. The port factors through LAPACK's
  `?gesdd` on the host (`ops/svd.py::_lapack_svd`, scipy), the JAX
  package's CPU `svd`, so it takes the JAX package's signs: on every
  well-separated component of the crops' stacks (`CROPS`), and its q20
  streams are within 0.01 dB of the JAX package's. `torch.linalg.svd`
  took other signs, most of all the leading component's (-0.31 dB at RGB
  q10, -1.56 dB at RGB q50 on this file's crop). With the port's factors
  given the JAX package's signs, the stream is within 0.1 dB.
- The codec's quantizer is the JAX package's jitted one: its scale is
  ``(max - min) * float32(1 / (qmax - qmin))``, as XLA compiles the
  division by a constant, bit for bit.
- `pil_encode` / `pil_decode` give the same bytes and arrays.
- `torch.linalg.svd`'s sides, which the codec no longer takes: its leading
  u column sums below 0 on tall stacks (M >= N) and above 0 on wide ones
  (the no-patch channels of a photograph); the JAX package's LAPACK agrees
  but on very wide ones (N >= ~1.8 M: the patch stacks of crops this
  small), where it takes the other side.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lrf_tpu
import lrf_tpu_torch
from lrf_tpu.models.container import bytes_to_dict, separate_bytes
from lrf_tpu.ops import svd as jsvd
from lrf_tpu_torch.models import svd as psvd
from lrf_tpu_torch.ops.quantize import dtype_range, torch_dtype

import torch_images

RNG = np.random.default_rng(29)
VARIANTS = [("RGB", True), ("RGB", False), ("YCbCr", True), ("YCbCr", False)]


@pytest.fixture(scope="module")
def crop():
    return torch_images.photos(1, 61, 93, seed=11)[0]


def _psnr(a, b):
    err = ((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).mean()
    return 20 * np.log10(255.0 / np.sqrt(err))


def _metadata(stream):
    return bytes_to_dict(separate_bytes(stream, 2)[0])


def _close_pixels(a, b):
    diff = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16])
def test_quantize_bit_equal(dtype):
    x = (RNG.standard_normal((70, 9)) * 5 + 1).astype(np.float32)
    x[10:20] += 20.0  # rows whose quantized minimum lies above qmin
    qj, sj, mj = lrf_tpu.quantize(jnp.asarray(x), dtype)
    qt, st, mt = lrf_tpu_torch.quantize(torch.from_numpy(x), dtype)
    assert qt.dtype == torch_dtype(dtype)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert (float(st), float(mt)) == (float(sj), float(mj))
    assert st.dtype == mt.dtype == torch.float32
    # the quirk: a slice whose q.min() is above qmin dequantizes from its own min
    part_j, part_t = np.asarray(qj)[10:20], qt[10:20]
    assert part_t.min() > dtype_range(dtype)[0]
    for q_j, q_t in ((np.asarray(qj), qt), (part_j, part_t)):
        want = np.asarray(lrf_tpu.dequantize(jnp.asarray(q_j), float(sj), float(mj)))
        np.testing.assert_array_equal(lrf_tpu_torch.dequantize(q_t, float(st), float(mt)).numpy(), want)
        np.testing.assert_array_equal(
            lrf_tpu_torch.np_dequantize(q_t.numpy(), float(st), float(mt)),
            lrf_tpu.np_dequantize(q_j, float(sj), float(mj)),
        )


@pytest.mark.parametrize("size,ratio,rank", [((64, 64), 8, 4), ((6144, 192), 12.5, 19), ((512, 768), 3.3, 100)])
def test_rank_helpers_equal(size, ratio, rank):
    assert lrf_tpu_torch.svd_rank(size, ratio) == lrf_tpu.svd_rank(size, ratio)
    assert lrf_tpu_torch.svd_compression_ratio(size, rank) == lrf_tpu.svd_compression_ratio(size, rank)


def _quantization_shape(md):
    def shape(v):
        return None if v is None else [shape(e) for e in v] if isinstance(v[0], list) else len(v)

    return {k: shape(v) for k, v in md["quantization"].items()}


@pytest.mark.parametrize("color_space,patch", VARIANTS)
def test_metadata_and_cross_decode(crop, color_space, patch):
    kw = dict(quality=20, color_space=color_space, patch=patch)
    s_jax = lrf_tpu.svd_encode(crop, **kw)
    s_port = lrf_tpu_torch.svd_encode(crop, device="cpu", **kw)
    md_j, md_t = _metadata(s_jax), _metadata(s_port)
    assert md_t.keys() == md_j.keys()
    assert {k: v for k, v in md_t.items() if k != "quantization"} == {
        k: v for k, v in md_j.items() if k != "quantization"
    }
    assert _quantization_shape(md_t) == _quantization_shape(md_j)
    for stream in (s_jax, s_port):
        by_jax = np.asarray(lrf_tpu.svd_decode(stream))
        by_port = lrf_tpu_torch.svd_decode(stream, device="cpu")
        assert by_port.shape == crop.shape and by_port.dtype == np.uint8
        _close_pixels(by_port, by_jax)


@pytest.mark.parametrize("color_space,patch", VARIANTS)
def test_float_factor_streams_decode_to_jax_pixels(crop, color_space, patch):
    kw = dict(rank=6, color_space=color_space, patch=patch, dtype=np.float32)
    s_jax = lrf_tpu.svd_encode(crop, **kw)
    s_port = lrf_tpu_torch.svd_encode(crop, device="cpu", **kw)
    assert _metadata(s_port)["quantization"] == _metadata(s_jax)["quantization"]
    _close_pixels(lrf_tpu_torch.svd_decode(s_port, device="cpu"), np.asarray(lrf_tpu.svd_decode(s_jax)))


@pytest.mark.parametrize("color_space,quality", [("RGB", 10), ("RGB", 50), ("YCbCr", 20)])
def test_quantized_stream_psnr_with_jax_signs(crop, monkeypatch, color_space, quality):
    kw = dict(quality=quality, color_space=color_space)
    p_jax = _psnr(crop, lrf_tpu.svd_decode(lrf_tpu.svd_encode(crop, **kw)))
    port_factors = psvd._balanced_factors

    def with_jax_signs(x, rank):
        u, v = port_factors(x, rank)
        u_j = torch.from_numpy(np.asarray(jsvd.svd_balanced_factors(jnp.asarray(x.numpy()), rank, method="svd")[0]))
        # the same components up to sign: |cos| ~ 1 per column
        cos = (u * u_j).sum(-2) / (u.norm(dim=-2) * u_j.norm(dim=-2))
        assert float((cos.abs() - 1).abs().max()) < 1e-3
        sign = torch.where(cos < 0, -1.0, 1.0)[..., None, :]
        return u * sign, v * sign

    monkeypatch.setattr(psvd, "_balanced_factors", with_jax_signs)
    p_port = _psnr(crop, lrf_tpu_torch.svd_decode(lrf_tpu_torch.svd_encode(crop, device="cpu", **kw), device="cpu"))
    assert abs(p_port - p_jax) < 0.1, (p_port, p_jax)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16])
def test_codec_quantizer_is_the_jitted_one(dtype):
    import jax

    from lrf_tpu_torch.ops.quantize import _jitted_quantize

    rng = np.random.default_rng(5)
    for _ in range(20):
        x = (rng.standard_normal((61, 12)) * rng.uniform(0.5, 20)).astype(np.float32)
        qj, sj, mj = jax.jit(lambda a: lrf_tpu.quantize(a, dtype))(jnp.asarray(x))
        qt, st, mt = _jitted_quantize(torch.from_numpy(x), dtype)
        assert (float(st), float(mt)) == (float(sj), float(mj))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


@pytest.mark.parametrize("kwargs", [dict(format="PNG"), dict(format="JPEG", quality=50)])
def test_pil_codec_equal(crop, kwargs):
    b_jax = lrf_tpu.pil_encode(crop, **kwargs)
    b_port = lrf_tpu_torch.pil_encode(torch.from_numpy(crop), **kwargs)
    assert b_port == b_jax
    np.testing.assert_array_equal(lrf_tpu_torch.pil_decode(b_port), lrf_tpu.pil_decode(b_jax))
    gray = crop[0]
    assert lrf_tpu_torch.pil_encode(gray, **kwargs) == lrf_tpu.pil_encode(gray, **kwargs)


# (H, W, seed, index) of the `torch_images.photos` crops whose stacks are
# held to the JAX package's signs, and how many of their components are
# well separated; torch.linalg.svd gives the JAX package's sign on 401, 400
# and 370 of them (1,171 of 1,430)
SEPARATED = {(61, 93, 11, 0): 512, (64, 96, 3, 1): 528, (48, 80, 7, 0): 390}
CROPS = sorted(SEPARATED)


def _crop_of(h, w, seed, index):
    return torch_images.photos(index + 1, h, w, seed=seed)[index]


@pytest.mark.parametrize("key", CROPS)
def test_lapack_svd_gives_jax_signs(key):
    # Every well-separated component (|cos| > 0.999 against the JAX
    # package's) of every stack the codec factors takes the JAX package's
    # sign; over the three crops that is 1,430 components
    from lrf_tpu_torch.ops.svd import _lapack_svd

    separated = 0
    for xm in _codec_stacks(_crop_of(*key)):
        u = _lapack_svd(xm)[0].numpy()
        u_j = np.asarray(jnp.linalg.svd(jnp.asarray(xm.numpy()), full_matrices=False)[0])
        cos = (u * u_j).sum(0) / (np.linalg.norm(u, axis=0) * np.linalg.norm(u_j, axis=0))
        well = np.abs(cos) > 0.999
        assert (cos[well] > 0).all(), (tuple(xm.shape), np.flatnonzero(well & (cos < 0)))
        separated += int(well.sum())
    assert separated == SEPARATED[key]


@pytest.mark.parametrize("color_space,patch", VARIANTS)
def test_quantized_stream_within_a_hundredth_db_of_jax(crop, color_space, patch):
    # no monkeypatch: the codec's own signs are the JAX package's, also on
    # the crop's very wide stacks (N >= ~1.8 M), where torch's LAPACK took
    # the other side for the leading component
    kw = dict(quality=20, color_space=color_space, patch=patch)
    p_jax = _psnr(crop, lrf_tpu.svd_decode(lrf_tpu.svd_encode(crop, **kw)))
    p_port = _psnr(crop, lrf_tpu_torch.svd_decode(lrf_tpu_torch.svd_encode(crop, device="cpu", **kw), device="cpu"))
    assert abs(p_port - p_jax) < 0.01, (p_port, p_jax)


def _codec_stacks(crop):
    """The matrices the SVD codec factors, per variant (RGB no-patch: one
    per color plane)."""
    from lrf_tpu_torch.ops.color import rgb_to_ycbcr
    from lrf_tpu_torch.ops.pad import pad_image
    from lrf_tpu_torch.ops.patch import patchify
    from lrf_tpu_torch.ops.resample import chroma_downsample

    x = torch.from_numpy(crop).to(torch.float32)
    stacks = [patchify(pad_image(x, (8, 8)), (8, 8)), *x]
    for c in chroma_downsample(rgb_to_ycbcr(x), (0.5, 0.5)):
        stacks += [patchify(pad_image(c, (8, 8)), (8, 8)), c[0]]
    return stacks


def _lead_sums(xm):
    from lrf_tpu_torch.ops.svd import svd_balanced_factors

    u_t, _ = svd_balanced_factors(xm, 4, method="svd")
    u_j, _ = jsvd.svd_balanced_factors(jnp.asarray(xm.numpy()), 4, method="svd")
    return float(u_t[:, 0].sum()), float(np.asarray(u_j)[:, 0].sum())


def test_lapack_gives_the_rules_side():
    # torch.linalg.svd's leading u column sums below 0 on every tall stack
    # of the crops and above 0 on every wide one. The JAX package's LAPACK
    # agrees on the tall stacks and on the wide ones up to N < ~1.8 M; on
    # the very wide patch stacks of such small crops (15 x 64, 24 x 64,
    # 60 x 192, 96 x 192) it takes the other side from torch's, which is why
    # the codec takes LAPACK's own factorization instead of a sign rule.
    sides = {"tall": 0, "wide": 0, "very wide, JAX's other side": 0}
    for key in CROPS:
        for xm in _codec_stacks(_crop_of(*key)):
            port, jax_side = _lead_sums(xm)
            m, n = xm.shape
            if m >= n:
                assert port < 0 and jax_side < 0, (m, n)
                sides["tall"] += 1
            elif n < 1.8 * m:
                assert port > 0 and jax_side > 0, (m, n)
                sides["wide"] += 1
            else:
                assert port > 0 and jax_side < 0, (m, n)
                sides["very wide, JAX's other side"] += 1
    assert sides == {"tall": 2, "wide": 19, "very wide, JAX's other side": 9}


def test_lapack_signs_a_photographs_wide_channels_positive():
    # The no-patch channels of a landscape photograph are wide (M < N):
    # there LAPACK's leading u column sums above 0 in both packages, so a
    # sign rule's side would depend on the shape
    photo = torch_images.load(os.path.join(torch_images.DATA, "local7", "china.png"))
    for xm in _codec_stacks(photo):
        port, jax_side = _lead_sums(xm)
        wide = xm.shape[0] < xm.shape[1]
        assert (port > 0) == (jax_side > 0) == wide, tuple(xm.shape)
