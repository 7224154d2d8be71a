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
  component moves its rounding error. LAPACK's `gesdd` in torch and in JAX
  pick different signs (most of all the leading component's), and the
  streams' PSNR then differs: on this file's crop by -0.31 dB (RGB q10),
  -1.56 dB (RGB q50) and +0.22 dB (YCbCr q20), on other crops by up to
  about 3 dB at q50. With the port's factors given the JAX package's
  signs, the port's stream is within 0.1 dB of the JAX package's (measured
  on this crop: at most 0.0033 dB); that is the contract held here.
- `pil_encode` / `pil_decode` give the same bytes and arrays.
- The encoder's leading-sign rule (`models/svd.py::_lead_sign`): the CPU
  streams are byte-identical to those of 91b3da8, the tree before the rule
  (sha256 digests taken there), because the CPU's LAPACK already gives the
  rule's side on every stack of these crops; a leading pair negated before
  the rule gives the same stream; and the rule's side is LAPACK's in the
  JAX package too, the leading u column summing below 0 on tall stacks (M
  >= N) and above 0 on wide ones (the no-patch channels of a photograph),
  but on very wide ones (N >= ~1.8 M: the patch stacks of crops this
  small), where the JAX package's LAPACK takes the other side.
"""

import hashlib
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
    port_factors = psvd.svd_balanced_factors

    def with_jax_signs(x, rank, method="gram"):
        u, v = port_factors(x, rank, method=method)
        u_j = torch.from_numpy(np.asarray(jsvd.svd_balanced_factors(jnp.asarray(x.numpy()), rank, method=method)[0]))
        # the same components up to sign: |cos| ~ 1 per column
        cos = (u * u_j).sum(-2) / (u.norm(dim=-2) * u_j.norm(dim=-2))
        assert float((cos.abs() - 1).abs().max()) < 1e-3
        sign = torch.where(cos < 0, -1.0, 1.0)[..., None, :]
        return u * sign, v * sign

    monkeypatch.setattr(psvd, "svd_balanced_factors", with_jax_signs)
    # every sign the JAX package's: the encoder's leading-sign rule would
    # re-sign the JAX package's leading component on a very wide stack
    # (N >= ~1.8 M, such as this crop's 96 x 192 RGB patch stack), where
    # its LAPACK takes the other side from torch's
    monkeypatch.setattr(psvd, "_lead_sign", lambda u, v: (u, v))
    p_port = _psnr(crop, lrf_tpu_torch.svd_decode(lrf_tpu_torch.svd_encode(crop, device="cpu", **kw), device="cpu"))
    assert abs(p_port - p_jax) < 0.1, (p_port, p_jax)


@pytest.mark.parametrize("kwargs", [dict(format="PNG"), dict(format="JPEG", quality=50)])
def test_pil_codec_equal(crop, kwargs):
    b_jax = lrf_tpu.pil_encode(crop, **kwargs)
    b_port = lrf_tpu_torch.pil_encode(torch.from_numpy(crop), **kwargs)
    assert b_port == b_jax
    np.testing.assert_array_equal(lrf_tpu_torch.pil_decode(b_port), lrf_tpu.pil_decode(b_jax))
    gray = crop[0]
    assert lrf_tpu_torch.pil_encode(gray, **kwargs) == lrf_tpu.pil_encode(gray, **kwargs)


# sha256 of the CPU streams at q10, q20 and q50 in RGB and YCbCr, with and
# without patches (`_rule_streams`), taken on 91b3da8 (before the sign rule)
RULE_DIGESTS = {
    (61, 93, 11, 0): "ae761ba34adc47582c7e6c9d4a0fc19cebfa3f2415f8ba5275bd192f21051cb0",
    (64, 96, 3, 1): "ce90181bd82c4a083e2c5a63d40ae37bf607fab8ef031dfd2852c4785c085d39",
    (48, 80, 7, 0): "f17fdbcfdd913cd5a56952d2a8c10095d32af7a3db460742f1c9e9814782abe8",
}


def _rule_crop(h, w, seed, index):
    return torch_images.photos(index + 1, h, w, seed=seed)[index]


def _rule_streams(crop):
    for color_space in ("RGB", "YCbCr"):
        for patch in (True, False):
            for q in (10, 20, 50):
                yield lrf_tpu_torch.svd_encode(crop, quality=q, color_space=color_space, patch=patch, device="cpu")


@pytest.mark.parametrize("key", sorted(RULE_DIGESTS))
def test_cpu_streams_equal_those_before_the_sign_rule(key):
    h = hashlib.sha256()
    for stream in _rule_streams(_rule_crop(*key)):
        h.update(stream)
    assert h.hexdigest() == RULE_DIGESTS[key]


@pytest.mark.parametrize("color_space,patch", VARIANTS)
def test_sign_rule_undoes_a_negated_leading_pair(crop, monkeypatch, color_space, patch):
    kw = dict(quality=20, color_space=color_space, patch=patch, device="cpu")
    want = lrf_tpu_torch.svd_encode(crop, **kw)
    port_factors = psvd.svd_balanced_factors
    flipped = []

    def negated_lead(x, rank, method="gram"):
        u, v = port_factors(x, rank, method=method)
        scale = torch.ones(u.shape[-1])
        scale[0] = -1.0
        flipped.append(True)
        return u * scale, v * scale

    monkeypatch.setattr(psvd, "svd_balanced_factors", negated_lead)
    assert lrf_tpu_torch.svd_encode(crop, **kw) == want
    assert flipped


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
    u_t, _ = psvd.svd_balanced_factors(xm, 4, method="svd")
    u_j, _ = jsvd.svd_balanced_factors(jnp.asarray(xm.numpy()), 4, method="svd")
    return float(u_t[:, 0].sum()), float(np.asarray(u_j)[:, 0].sum())


def test_lapack_gives_the_rules_side():
    # The precondition of the digests above: the CPU solver's leading u
    # column sums below 0 on every tall stack of the crops and above 0 on
    # every wide one, so the rule changes nothing there. The JAX package's
    # LAPACK agrees on the tall stacks and on the wide ones up to N < ~1.8 M;
    # on the very wide patch stacks of such small crops (15 x 64, 24 x 64,
    # 60 x 192, 96 x 192) it takes the other side from torch's.
    sides = {"tall": 0, "wide": 0, "very wide, JAX's other side": 0}
    for key in RULE_DIGESTS:
        for xm in _codec_stacks(_rule_crop(*key)):
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
    # there LAPACK's leading u column sums above 0 in both packages, which
    # is why the rule's side depends on the shape
    photo = torch_images.load(os.path.join(torch_images.DATA, "local7", "china.png"))
    for xm in _codec_stacks(photo):
        port, jax_side = _lead_sums(xm)
        wide = xm.shape[0] < xm.shape[1]
        assert (port > 0) == (jax_side > 0) == wide, tuple(xm.shape)
