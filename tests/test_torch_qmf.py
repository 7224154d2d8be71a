"""The port's QMF codec against the JAX package's, on the CPU.

- Cross-decode: each package decodes the other's streams; decoded pixels of
  one stream differ between the packages by at most 1, in under 0.1% of
  pixels (the 3x3 color mix is summed in another order before a truncating
  cast).
- Rate-distortion: |dPSNR| < 0.2 dB against `lrf_tpu.qmf_encode`, with
  identical metadata dicts.
- Batching: on the CPU the port's batched streams are byte-identical to its
  per-image streams, and batched decode is bit-identical to per-image decode.
"""

import os

import numpy as np
import pytest
import torch

import lrf_tpu
import lrf_tpu_torch
from lrf_tpu.models.container import bytes_to_dict, separate_bytes
from PIL import Image

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments", "data")


def _load(name):
    return np.asarray(Image.open(os.path.join(DATA, name)).convert("RGB")).transpose(2, 0, 1)


@pytest.fixture(scope="module")
def photo():
    return _load("demo/kodim01.png")


def _crop(img, h, w, top=100, left=200):
    return np.ascontiguousarray(img[:, top : top + h, left : left + w])


def _psnr(a, b):
    return float(lrf_tpu_torch.psnr(a, b))


def _metadata(stream):
    return bytes_to_dict(separate_bytes(stream, 2)[0])


@pytest.mark.parametrize("size", [(128, 192), (61, 93)])
# q40: Y stacks (1, 384, 64, 26) and (1, 96, 64, 26), the wide-rank regime;
# q75: (1, 384, 64, 48) and (1, 96, 64, 48), the grid kernel's on the card
@pytest.mark.parametrize("quality", [10, 20, 40, 75])
def test_cross_decode_and_rd(photo, size, quality):
    crop = _crop(photo, *size)
    s_jax = lrf_tpu.qmf_encode(crop, quality=quality)
    s_port = lrf_tpu_torch.qmf_encode(crop, quality=quality, device="cpu")
    assert _metadata(s_port) == _metadata(s_jax)
    for stream in (s_jax, s_port):
        by_jax = np.asarray(lrf_tpu.qmf_decode(stream))
        by_port = lrf_tpu_torch.qmf_decode(stream, device="cpu")
        assert by_port.shape == crop.shape and by_port.dtype == np.uint8
        diff = np.abs(by_jax.astype(np.int16) - by_port.astype(np.int16))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 1e-3
    p_jax = _psnr(crop, lrf_tpu.qmf_decode(s_jax))
    p_port = _psnr(crop, lrf_tpu_torch.qmf_decode(s_port, device="cpu"))
    assert abs(p_jax - p_port) < 0.2, (p_jax, p_port)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(color_space="RGB", patch=True),
        dict(color_space="RGB", patch=False),
        dict(color_space="YCbCr", patch=False),
        dict(rank=5),
        dict(rank=(4, 2, 3)),
    ],
)
def test_other_variants_match_jax(photo, kwargs):
    crop = _crop(photo, 64, 96)
    kw = dict(quality=15, **kwargs) if "rank" not in kwargs else kwargs
    s_jax = lrf_tpu.qmf_encode(crop, **kw)
    s_port = lrf_tpu_torch.qmf_encode(crop, device="cpu", **kw)
    assert _metadata(s_port) == _metadata(s_jax)
    dec = lrf_tpu_torch.qmf_decode(s_port, device="cpu")
    np.testing.assert_array_equal(np.asarray(lrf_tpu.qmf_decode(s_port)).shape, dec.shape)
    assert abs(_psnr(crop, lrf_tpu.qmf_decode(s_jax)) - _psnr(crop, dec)) < 0.2


def test_local7_image_rd():
    crop = _crop(_load("local7/grace_hopper.png"), 96, 128, top=40, left=60)
    p_jax = _psnr(crop, lrf_tpu.qmf_decode(lrf_tpu.qmf_encode(crop, quality=10)))
    p_port = _psnr(crop, lrf_tpu_torch.qmf_decode(lrf_tpu_torch.qmf_encode(crop, quality=10, device="cpu"), device="cpu"))
    assert abs(p_jax - p_port) < 0.2


def test_batched_matches_per_image(photo):
    rng = np.random.default_rng(5)
    batch = np.stack([_crop(photo, 48, 64, top=t, left=l) for t, l in ((0, 0), (200, 300), (400, 500))])
    batch = np.concatenate([batch, rng.integers(0, 256, (1, 3, 48, 64)).astype(np.uint8)])
    streams = lrf_tpu_torch.sharded_qmf_encode_batch(batch, quality=20, num_iters=3, device="cpu")
    singles = [lrf_tpu_torch.qmf_encode(img, quality=20, num_iters=3, device="cpu") for img in batch]
    assert streams == singles
    dec = lrf_tpu_torch.sharded_qmf_decode_batch(streams, device="cpu")
    assert dec.shape == batch.shape and dec.dtype == np.uint8
    for i, s in enumerate(streams):
        np.testing.assert_array_equal(dec[i], lrf_tpu_torch.qmf_decode(s, device="cpu"))
    on_device = lrf_tpu_torch.sharded_qmf_decode_batch(streams, device="cpu", out="device")
    assert isinstance(on_device, torch.Tensor)
    np.testing.assert_array_equal(on_device.numpy(), dec)
    with pytest.raises(ValueError):
        lrf_tpu_torch.sharded_qmf_decode_batch(streams, device="cpu", out="gpu")
    # the JAX package's batched decoder reads the port's batch too
    from lrf_tpu.parallel.decode import sharded_qmf_decode_batch
    from lrf_tpu.parallel.mesh import make_mesh

    by_jax = np.asarray(sharded_qmf_decode_batch(streams, make_mesh(data=4, patch=2)))
    assert np.abs(by_jax.astype(np.int16) - dec.astype(np.int16)).max() <= 1


def test_plain_backend_gives_same_streams_on_cpu(photo):
    batch = np.stack([_crop(photo, 40, 56, top=t) for t in (0, 64)])
    auto = lrf_tpu_torch.sharded_qmf_encode_batch(batch, quality=10, device="cpu")
    plain = lrf_tpu_torch.sharded_qmf_encode_batch(batch, quality=10, device="cpu", backend="torch")
    assert auto == plain
    with pytest.raises(ValueError):
        lrf_tpu_torch.sharded_qmf_encode_batch(batch, quality=10, device="cpu", backend="pallas")


def test_qmf_rank_and_errors():
    assert lrf_tpu_torch.qmf_rank((768, 512), 10) == lrf_tpu.qmf_rank((768, 512), 10)
    img = np.zeros((3, 16, 16), np.uint8)
    with pytest.raises(ValueError):
        lrf_tpu_torch.qmf_encode(img, device="cpu")
    with pytest.raises(ValueError):
        lrf_tpu_torch.qmf_encode(img, quality=10, color_space="HSV", device="cpu")
