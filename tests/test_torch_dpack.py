"""The port's dpack coder (delta + static Huffman) against the JAX package's,
and the batched decode's upload of streams outside the bounds.

- `ops/entropy.py::unpack_chunks_device` equals
  `lrf_tpu.ops.entropy.unpack_chunks_device` value for value on one upload
  built by the port's host encoder (`native.dpack_encode`), and both equal
  the raw factors. No pipeline calls either: they are kept as the port of
  the JAX package's coder.
- `num_iters=0` streams (values outside the bounds) take the unpacked
  upload, with per-image `qmf_decode`'s pixels; the host encoder refuses a
  delta outside the code's alphabet.

    python -m pytest --noconftest -m cuda tests/test_torch_dpack.py
"""

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
    """Per-test decode counts."""
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
    """The host encoder's dpack upload of `factors` (`native.dpack_encode`
    of their fiber-major buffers): per-chunk row counts, main and used
    continuation rows as numpy words, and the shapes."""
    b = factors[0].shape[0]
    raws = [np.ascontiguousarray(f.transpose(0, 2, 1)).reshape(-1, f.shape[1]) for f in factors]
    ms, rs = [f.shape[1] for f in factors], [f.shape[2] for f in factors]
    shapes = [f.shape for f in factors]
    c_total = te.segment_layout(shapes)[2][-1]
    main, exc, rows_u8, n_rows = tnative.dpack_encode(
        raws, b, ms, rs, te.LENS, te.CODES, te.CHUNK, te.MAIN_WORDS, te.ROW_WORDS, te.default_exc_rows(c_total)
    )
    assert rows_u8.size == c_total and main.size == c_total * te.MAIN_WORDS and n_rows > 0
    return rows_u8, main, exc[: n_rows * te.ROW_WORDS], shapes


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


def test_num_iters_zero_takes_another_upload():
    # Unprojected factors of bright images: v's first row reaches -35, a
    # delta outside the code's alphabet (|d| <= 31) and a value outside the
    # bounds, so the native pack declines and the batch uploads unpacked.
    images = np.full((2, 3, 256, 384), 255, np.uint8)
    images[1, :, ::7] = 200
    streams = lt.sharded_qmf_encode_batch(images, quality=20, num_iters=0, device="cpu")
    dec = lt.sharded_qmf_decode_batch(streams, device="cpu")
    assert tdec.TRANSPORT_COUNTS == {"flat": 0, "unpacked": 1}
    for i, s in enumerate(streams):
        np.testing.assert_array_equal(dec[i], lt.qmf_decode(s, device="cpu"))
    # the host encoder's own refusal of an out-of-alphabet delta
    f = np.zeros((1, 64, 1), np.int8)
    f[0, 1, 0] = 100
    args = (te.LENS, te.CODES, te.CHUNK, te.MAIN_WORDS, te.ROW_WORDS, 64)
    assert tnative.dpack_encode([f.reshape(1, 64)], 1, [64], [1], *args) is None


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
    for c, g, f in zip(cpu, gpu, factors):
        assert torch.equal(c, g.cpu())
        np.testing.assert_array_equal(c.numpy(), f.astype(np.int32))
