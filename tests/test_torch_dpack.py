"""The port's dpack decode transport against the JAX package's.

- `ops/entropy.py::unpack_chunks_device` equals
  `lrf_tpu.ops.entropy.unpack_chunks_device` value for value on one upload
  buffer built by the port's host encoder, and both equal the raw factors.
- `transport="dpack"` decodes to the flat transport's pixels and to
  per-image `qmf_decode`'s, one-shot and pipelined, and the batch took it.
- The upload carries only used rows, in a bucket that sticks per config.
- `num_iters=0` streams (deltas outside the alphabet, values outside the
  bounds) and several-device meshes take the other uploads, same pixels.

    python -m pytest --noconftest -m cuda tests/test_torch_dpack.py
"""

import json

import numpy as np
import pytest
import torch

import lrf_tpu_torch as lt
from lrf_tpu_torch.native import fibercodec as tnative
from lrf_tpu_torch.ops import entropy as te
from lrf_tpu_torch.parallel import decode as tdec
from torch_images import photos

KW = dict(quality=20, num_iters=3)


@pytest.fixture(scope="module")
def batch():
    return photos(4, 64, 96, seed=1)


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Per-test decode state: pack decisions, sticky buckets, counts."""
    monkeypatch.setattr(tdec, "_PACK_DECISIONS", {})
    monkeypatch.setattr(tdec, "_DPACK_BUCKETS", {})
    monkeypatch.setattr(tdec, "TRANSPORT_COUNTS", dict.fromkeys(tdec.TRANSPORT_COUNTS, 0))


def _factors(batch):
    """Raw int8 factors of a CPU encode, plus an extreme-delta factor (the
    most continuation rows a chunk can take)."""
    fn, _, _ = lt.build_sharded_encoder("cpu", batch.shape[-2:], **KW)
    factors = [f.numpy() for f in fn(torch.from_numpy(batch))]
    rng = np.random.default_rng(12)
    factors.append(np.where(rng.random((batch.shape[0], 16, 4)) < 0.5, -16, 15).astype(np.int8))
    return factors


def _upload(factors):
    """The port's dpack upload of `factors` and the slices the decoder cuts
    from it: (rows_u8, main, exc) as numpy words, and the shapes."""
    b = factors[0].shape[0]
    raws = [np.ascontiguousarray(f.transpose(0, 2, 1)).reshape(-1, f.shape[1]) for f in factors]
    ms, rs = [f.shape[1] for f in factors], [f.shape[2] for f in factors]
    upload, pack = tdec._dpack_upload(raws, b, ms, rs, "test")
    shapes = [f.shape for f in factors]
    c_total = te.segment_layout(shapes)[2][-1]
    rows_words = -(-c_total // 4)
    rows_u8 = upload[:rows_words].view(np.uint8)[:c_total]
    main_end = rows_words + c_total * te.MAIN_WORDS
    assert upload.size == main_end + pack[2] * te.ROW_WORDS
    return rows_u8, upload[rows_words:main_end], upload[main_end:], shapes


def test_unpack_chunks_device_matches_jax(batch):
    import jax.numpy as jnp

    from lrf_tpu.ops import entropy as je

    assert te._INV_STEPS == je._INV_STEPS
    factors = _factors(batch)
    rows_u8, main, exc, shapes = _upload(factors)
    got = te.unpack_chunks_device(
        torch.from_numpy(rows_u8), torch.from_numpy(main.view(np.int32)), torch.from_numpy(exc.view(np.int32)), shapes
    )
    want = je.unpack_chunks_device(jnp.asarray(rows_u8), jnp.asarray(main), jnp.asarray(exc), shapes)
    for g, w, f in zip(got, want, factors):
        assert g.dtype == torch.int32 and tuple(g.shape) == f.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), f.astype(np.int32))


def test_dpack_decode_equals_flat_and_per_image(batch):
    streams = lt.sharded_qmf_encode_batch(batch, device="cpu", **KW)
    upload, _, shapes, in_dtype, pack = tdec._inflate_streams(streams, True, "dpack")
    assert pack[0] == "dpack" and pack[1] == len(streams) and upload.ndim == 1 and in_dtype == "int8"
    assert upload.nbytes < tdec._inflate_streams(streams, True, "flat")[0].nbytes
    dec = lt.sharded_qmf_decode_batch(streams, device="cpu", transport="dpack")
    assert tdec.TRANSPORT_COUNTS == {"dpack": 1, "flat": 0, "unpacked": 0}
    np.testing.assert_array_equal(dec, lt.sharded_qmf_decode_batch(streams, device="cpu"))
    assert tdec.TRANSPORT_COUNTS == {"dpack": 1, "flat": 1, "unpacked": 0}
    for i, s in enumerate(streams):
        np.testing.assert_array_equal(dec[i], lt.qmf_decode(s, device="cpu"))
    on_device = lt.sharded_qmf_decode_batch(streams, device="cpu", out="device", transport="dpack")
    assert isinstance(on_device, torch.Tensor) and torch.equal(on_device, torch.from_numpy(dec))
    small = lt.sharded_qmf_encode_batch(batch[:2, :, :32, :40], device="cpu", **KW)
    outs = list(lt.sharded_qmf_decode_batches([streams, small, streams], device="cpu", transport="dpack"))
    np.testing.assert_array_equal(outs[0], dec)
    np.testing.assert_array_equal(outs[2], dec)
    np.testing.assert_array_equal(outs[1], lt.sharded_qmf_decode_batch(small, device="cpu"))
    assert tdec.TRANSPORT_COUNTS["dpack"] == 5


def test_sticky_bucket(batch, monkeypatch):
    # A small bucket makes row counts land in different buckets: the upload
    # keeps the largest bucket its config has needed.
    monkeypatch.setattr(tdec, "_DPACK_BUCKET_ROWS", 16)
    rng = np.random.default_rng(3)
    noisy = np.clip(batch.astype(np.int16) + rng.integers(-8, 9, batch.shape), 0, 255).astype(np.uint8)
    smooth = np.repeat(batch[:, :1], 3, axis=1) // 2 + 64
    rows = {}
    for name, images in (("smooth", smooth), ("noisy", noisy), ("smooth again", smooth)):
        streams = lt.sharded_qmf_encode_batch(images, device="cpu", **KW)
        rows[name] = tdec._inflate_streams(streams, True, "dpack")[4][2]
        np.testing.assert_array_equal(
            lt.sharded_qmf_decode_batch(streams, device="cpu", transport="dpack"),
            lt.sharded_qmf_decode_batch(streams, device="cpu"),
        )
    assert rows["smooth"] % 16 == 0 and rows["smooth"] < rows["noisy"] == rows["smooth again"], rows
    # one config; its bucket is whole, capped at the row budget in the upload
    (key,) = tdec._DPACK_BUCKETS
    assert json.loads(key)["rank"] and tdec._DPACK_BUCKETS[key] % 16 == 0
    assert tdec._DPACK_BUCKETS[key] >= rows["noisy"] > tdec._DPACK_BUCKETS[key] - 16


def test_num_iters_zero_takes_another_upload():
    # Unprojected factors of bright images: v's first row reaches -35, a
    # delta outside the code's alphabet (|d| <= 31) and a value outside the
    # bounds, so the host encoder declines and the batch uploads unpacked.
    images = np.full((2, 3, 256, 384), 255, np.uint8)
    images[1, :, ::7] = 200
    streams = lt.sharded_qmf_encode_batch(images, quality=20, num_iters=0, device="cpu")
    dec = lt.sharded_qmf_decode_batch(streams, device="cpu", transport="dpack")
    assert tdec.TRANSPORT_COUNTS == {"dpack": 0, "flat": 0, "unpacked": 1}
    for i, s in enumerate(streams):
        np.testing.assert_array_equal(dec[i], lt.qmf_decode(s, device="cpu"))
    # the host encoder's own refusal of an out-of-alphabet delta
    f = np.zeros((1, 64, 1), np.int8)
    f[0, 1, 0] = 100
    args = (te.LENS, te.CODES, te.CHUNK, te.MAIN_WORDS, te.ROW_WORDS, 64)
    assert tnative.dpack_encode([f.reshape(1, 64)], 1, [64], [1], *args) is None


def test_no_dpack_on_a_multi_device_mesh(batch):
    streams = lt.sharded_qmf_encode_batch(batch, device="cpu", **KW)
    mesh = lt.make_mesh(data=2, devices=["cpu", "cpu"])
    dec = lt.sharded_qmf_decode_batch(streams, device=mesh, transport="dpack")
    assert tdec.TRANSPORT_COUNTS == {"dpack": 0, "flat": 1, "unpacked": 0}
    np.testing.assert_array_equal(dec, lt.sharded_qmf_decode_batch(streams, device="cpu", transport="dpack"))
    assert tdec._inflate_streams(streams, transport="dpack")[4][0] != "dpack"  # single_device defaults to False
    with pytest.raises(ValueError, match="transport"):
        lt.sharded_qmf_decode_batch(streams, device="cpu", transport="huffman")


@pytest.mark.cuda
def test_unpack_on_gpu_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    images = photos(4, 96, 128, seed=2)
    factors = _factors(images)
    rows_u8, main, exc, shapes = _upload(factors)
    args = [torch.from_numpy(rows_u8), torch.from_numpy(main.view(np.int32)), torch.from_numpy(exc.view(np.int32))]
    cpu = te.unpack_chunks_device(*args, shapes)
    gpu = te.unpack_chunks_device(*[a.cuda() for a in args], shapes)
    for c, g in zip(cpu, gpu):
        assert torch.equal(c, g.cpu())
    streams = lt.sharded_qmf_encode_batch(images, quality=10)
    np.testing.assert_array_equal(
        lt.sharded_qmf_decode_batch(streams, transport="dpack"), lt.sharded_qmf_decode_batch(streams)
    )
