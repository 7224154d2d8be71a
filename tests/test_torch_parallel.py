"""The port's batched codec host tail against the JAX package's.

- Transports: raw factors, the flat pack and the entropy pack give
  byte-identical streams, equal to per-image `qmf_encode` on the CPU.
- `_serialize_batch` on the same fetched buffers gives the JAX package's
  streams, for each transport and each fiber coder, and the plain
  pure-Python serializer's under "zlib".
- The pipelined encoder gives the one-shot streams, in order, across image
  sizes, including when a batch overflows the entropy row budget.
- The batched encoders take the JAX package's argument order.
- Batched decode takes the packed upload and equals per-image decode; so
  does the pipelined decode; the JAX package decodes the port's streams to
  the port's pixels.
- The pipelined decode of 1-3 batches (and of 3 over a 2-row mesh) yields,
  in order, each batch's one-shot pixels, which stay as they are while
  later batches decode; it closes cleanly after its first answer; CPU
  pixels are counted as taken as they are. On a card the answers are
  views of page-locked blocks, and the wait for them releases the GIL.

The JAX package is imported inside the tests that use it, so the `cuda`
test runs on a GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel.py
"""

import os
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import lrf_tpu_torch as lt
from lrf_tpu_torch.models import container as tc
from lrf_tpu_torch.native import fibercodec as tnative
from lrf_tpu_torch.ops import entropy as tentropy
from lrf_tpu_torch.parallel import decode as tdec
from lrf_tpu_torch.parallel import encode as tenc
from lrf_tpu_torch.parallel.mesh import make_mesh
from lrf_tpu_torch.utils.transfer import HostCopy

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments", "data")
KW = dict(quality=20, num_iters=3)


def _photos(b, h, w):
    img = np.asarray(Image.open(os.path.join(DATA, "demo", "kodim01.png")).convert("RGB")).transpose(2, 0, 1)
    return np.stack([np.ascontiguousarray(img[:, 40 * i : 40 * i + h, 60 * i : 60 * i + w]) for i in range(b)])


@pytest.fixture(scope="module")
def batch():
    return _photos(4, 48, 64)


@pytest.fixture
def coders():
    """Both packages' process-wide coders, restored afterwards."""
    from lrf_tpu.models import container as jc

    saved = jc.get_fiber_coder(), tc.get_fiber_coder()
    yield jc
    jc.set_fiber_coder(*saved[0])
    tc.set_fiber_coder(*saved[1])


def _host_buffers(images, pack):
    """Fetched host buffers of one CPU encode with `pack`, and its spec."""
    b = images.shape[0]
    fn, metadata, spec = tenc.build_sharded_encoder("cpu", images.shape[-2:], batch=b, pack=pack, **KW)
    return tenc._fetch_encoded(HostCopy(fn(torch.from_numpy(images))), spec), spec, metadata


def test_transports_give_identical_streams(batch):
    raw = lt.sharded_qmf_encode_batch(batch, device="cpu", **KW)
    assert raw == [lt.qmf_encode(img, device="cpu", **KW) for img in batch]
    for pack in ("flat", True, "entropy"):
        assert lt.sharded_qmf_encode_batch(batch, device="cpu", pack=pack, **KW) == raw, pack
    host, spec, _ = _host_buffers(batch, "entropy")
    assert int(host[0][-1]) <= spec["exc_budget"]  # this batch fits the default budget
    raw_factors, _, _ = _host_buffers(batch, None)
    for got, want in zip(tenc._decode_entropy(host, spec), raw_factors):
        np.testing.assert_array_equal(got, want)
    flat, flat_spec, _ = _host_buffers(batch, "flat")
    assert flat.dtype == np.uint32 and flat_spec["bits"] == 5
    for got, want in zip(tenc._unpack_factors(flat, flat_spec["shapes"], np.int8, -16, 5), raw_factors):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("coder", ["zlib", "best", "deflate"])
@pytest.mark.parametrize("pack", [None, "flat", "entropy"])
def test_serialize_batch_matches_jax(batch, coders, pack, coder):
    # Same fetched buffers through both packages' host tails: same streams.
    import jax
    from lrf_tpu.native import fibercodec as jnative
    from lrf_tpu.parallel import encode as jenc
    from lrf_tpu.parallel.mesh import make_mesh

    if not jnative.available():
        pytest.skip("the JAX package's native fiber coder does not load here")
    if coder == "deflate" and "deflate" not in tnative.backends():
        pytest.skip("the port's native coder was built without libdeflate")
    jc = coders
    b = batch.shape[0]
    host, spec, metadata = _host_buffers(batch, pack)
    _, j_metadata, j_spec = jenc.build_sharded_encoder(
        make_mesh(data=1, patch=1, devices=jax.devices()[:1]), batch.shape[-2:], batch=b, pack=pack or False, **KW
    )
    assert j_metadata == metadata
    jc.set_fiber_coder(coder)
    tc.set_fiber_coder(coder)
    got = tenc._serialize_batch(host, spec, metadata, b)
    assert got == jenc._serialize_batch(host, j_spec, j_metadata, b)
    if coder == "zlib":
        raw, _, _ = _host_buffers(batch, None)
        assert got == tenc._serialize_plain(raw, metadata, b)


def test_entropy_rejects_non_canonical(batch):
    with pytest.raises(ValueError):
        lt.sharded_qmf_encode_batch(batch, quality=20, num_iters=1, bounds=(-8, 7), pack="entropy", device="cpu")
    with pytest.raises(ValueError):
        lt.sharded_qmf_encode_batch(batch, quality=20, num_iters=0, pack="entropy", device="cpu")
    with pytest.raises(ValueError):
        lt.sharded_qmf_encode_batch(batch, pack="lz4", device="cpu", **KW)
    # without a batch size the factors stay raw
    assert lt.build_sharded_encoder("cpu", (48, 64), pack="flat", **KW)[2] is None


@pytest.mark.parametrize("pack", [None, "entropy"])
def test_pipelined_encode_matches_one_shot(batch, pack):
    small = np.ascontiguousarray(batch[:3, :, :32, :40])
    batches = [batch, small, batch[::-1].copy(), small]
    want = [lt.sharded_qmf_encode_batch(x, device="cpu", pack=pack, **KW) for x in batches]
    got = list(lt.sharded_qmf_encode_batches(batches, device="cpu", pack=pack, depth=2, **KW))
    assert got == want
    assert list(lt.sharded_qmf_encode_batches([], device="cpu", **KW)) == []
    with pytest.raises(ValueError):
        next(lt.sharded_qmf_encode_batches(batches, device="cpu", depth=0, **KW))


def test_jax_style_positional_arguments(batch):
    # The JAX package's order: (images, mesh, quality, rank) and
    # (batches, mesh, quality, rank, depth).
    want = lt.sharded_qmf_encode_batch(batch, device="cpu", quality=20, num_iters=3)
    assert lt.sharded_qmf_encode_batch(batch, "cpu", 20, num_iters=3) == want
    assert lt.sharded_qmf_encode_batch(batch, lt.make_mesh(devices=["cpu"] * 2), 20, None, num_iters=3) == want
    halves = [batch[:2], batch[2:]]
    got = list(lt.sharded_qmf_encode_batches(halves, "cpu", 20, None, 1, num_iters=3))
    assert got == [want[:2], want[2:]]
    assert got == list(lt.sharded_qmf_encode_batches(halves, device="cpu", quality=20, depth=1, num_iters=3))


def test_pipelined_overflow_fallback(batch, monkeypatch):
    # A tiny row budget makes the first entropy-packed batches overflow: they
    # come back flat-packed with the same bytes, in order, and the budget
    # grows so that batches built after the first overflow was observed
    # (beyond the in-flight depth) stay on the entropy transport.
    b4 = batch[:4]
    want = lt.sharded_qmf_encode_batch(b4, device="cpu", **KW)
    monkeypatch.setattr(tentropy, "default_exc_rows", lambda c_total: 8)
    monkeypatch.setattr(tenc, "_EXC_ROWS_HINT", {})
    monkeypatch.setattr(tenc, "_EXC_ROWS_OBS", {})
    monkeypatch.setattr(tenc, "ENTROPY_STATS", dict.fromkeys(tenc.ENTROPY_STATS, 0))
    got = []
    for streams in lt.sharded_qmf_encode_batches([b4] * 5, device="cpu", pack="entropy", depth=2, **KW):
        got.extend(streams)
    assert got == want * 5
    stats = tenc.ENTROPY_STATS
    assert stats["fallbacks"] >= 1 and stats["budget_bumps"] >= 1
    assert stats["batches"] == 5 and stats["fallbacks"] <= 3
    # the one-shot entry point falls back the same way
    monkeypatch.setattr(tenc, "_EXC_ROWS_HINT", {})
    assert lt.sharded_qmf_encode_batch(b4, device="cpu", pack="entropy", **KW) == want
    assert stats["fallbacks"] == 4


def test_batched_decode_takes_the_packed_upload(batch):
    streams = lt.sharded_qmf_encode_batch(batch, device="cpu", **KW)
    flat, _, shapes, in_dtype, pack = tdec._inflate_streams(streams)
    assert pack is not None and pack[:2] == (-16, 5) and pack[2] == sum(m * r for m, r in shapes)
    assert flat.dtype == np.uint32 and in_dtype == "int8"
    singles = [lt.qmf_decode(s, device="cpu") for s in streams]
    dec = lt.sharded_qmf_decode_batch(streams, device="cpu")
    for i in range(len(streams)):
        np.testing.assert_array_equal(dec[i], singles[i])
    small = lt.sharded_qmf_encode_batch(batch[:2, :, :32, :40], device="cpu", **KW)
    outs = list(lt.sharded_qmf_decode_batches([streams, small, streams], device="cpu"))
    assert len(outs) == 3
    np.testing.assert_array_equal(outs[0], dec)
    np.testing.assert_array_equal(outs[2], dec)
    np.testing.assert_array_equal(outs[1], lt.sharded_qmf_decode_batch(small, device="cpu"))
    # num_iters=0 streams hold unprojected factors: unpacked upload or not,
    # the batched decode still equals the per-image one
    raw = lt.sharded_qmf_encode_batch(batch, quality=20, num_iters=0, device="cpu")
    dec0 = lt.sharded_qmf_decode_batch(raw, device="cpu")
    for i, s in enumerate(raw):
        np.testing.assert_array_equal(dec0[i], lt.qmf_decode(s, device="cpu"))


@pytest.fixture(scope="module")
def stream_batches():
    """Three CPU-encoded batches of two photos each, all different."""
    photos = _photos(6, 48, 64)
    return [lt.sharded_qmf_encode_batch(photos[2 * k : 2 * k + 2], device="cpu", **KW) for k in range(3)]


def _held_in_order(batches, device, want):
    """The pipeline's answers, each checked against `want`, the one-shot
    decodes, as it comes, and copies of them taken then."""
    got, snapshots = [], []
    for k, pixels in enumerate(tdec.sharded_qmf_decode_batches(batches, device=device)):
        np.testing.assert_array_equal(pixels, want[k])
        got.append(pixels)
        snapshots.append(pixels.copy())
    assert len(got) == len(batches)
    return got, snapshots


@pytest.mark.parametrize("n,rows", [(1, 1), (2, 1), (3, 1), (3, 2)], ids=["1", "2", "3", "3-mesh2"])
def test_pipelined_decode_yields_one_shot_pixels_in_order(stream_batches, n, rows):
    device = make_mesh(data=rows, devices=["cpu"] * rows) if rows > 1 else "cpu"
    want = [lt.sharded_qmf_decode_batch(s, device=device) for s in stream_batches[:n]]
    before = dict(tdec.PIXEL_COPY_COUNTS)
    got, snapshots = _held_in_order(stream_batches[:n], device, want)
    # every answer held while later batches decoded is as it was yielded
    for pixels, snap in zip(got, snapshots):
        np.testing.assert_array_equal(pixels, snap)
    counts = tdec.PIXEL_COPY_COUNTS
    assert counts["host"] - before["host"] == n
    assert counts["pinned"] == before["pinned"] and counts["ready"] == before["ready"]


def test_device_decode_returns_a_finished_array(stream_batches):
    staged = tdec._inflate_streams(stream_batches[0], True)
    pixels = tdec._device_decode(*staged, tdec.as_mesh("cpu"), "host")
    assert isinstance(pixels, np.ndarray) and pixels.dtype == np.uint8 and pixels.shape == (2, 3, 48, 64)
    np.testing.assert_array_equal(pixels, lt.sharded_qmf_decode_batch(stream_batches[0], device="cpu"))


def test_pipelined_decode_closes_after_its_first_answer(stream_batches):
    gen = tdec.sharded_qmf_decode_batches(stream_batches, device="cpu")
    first = next(gen)
    gen.close()
    np.testing.assert_array_equal(first, lt.sharded_qmf_decode_batch(stream_batches[0], device="cpu"))


def test_jax_decodes_port_streams_to_port_pixels(batch):
    import lrf_tpu

    streams = lt.sharded_qmf_encode_batch(batch, device="cpu", **KW)
    dec = lt.sharded_qmf_decode_batch(streams, device="cpu")
    for i, s in enumerate(streams):
        np.testing.assert_array_equal(np.asarray(lrf_tpu.qmf_decode(s)), dec[i])


def test_native_serializer_threads_give_same_streams(batch):
    # Two serializer workers run the native assembler at once (as the
    # pipeline does); each must give the single-threaded bytes.
    from concurrent.futures import ThreadPoolExecutor

    host, spec, metadata = _host_buffers(batch, "entropy")
    want = tenc._serialize_batch(host, spec, metadata, batch.shape[0])
    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = [pool.submit(tenc._serialize_batch, host, spec, metadata, batch.shape[0]) for _ in range(8)]
        assert all(f.result(timeout=120) == want for f in futs)


@pytest.mark.cuda
def test_pipelined_encode_on_gpu_matches_one_shot():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the BCD kernel has no CPU mode)")
    rng = np.random.default_rng(4)
    base = _photos(4, 96, 128)
    batches = [base, np.clip(base.astype(np.int16) + rng.integers(-3, 4, base.shape), 0, 255).astype(np.uint8)]
    for pack in (None, "flat", "entropy"):
        want = [lt.sharded_qmf_encode_batch(x, quality=10, pack=pack) for x in batches]
        assert list(lt.sharded_qmf_encode_batches(batches, quality=10, pack=pack)) == want
        assert want[0] == lt.sharded_qmf_encode_batch(batches[0], quality=10)
    dec = [lt.sharded_qmf_decode_batch(s) for s in want]
    for got, d in zip(lt.sharded_qmf_decode_batches(want), dec):
        np.testing.assert_array_equal(got, d)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2], ids=["card", "mesh2"])
def test_pipelined_decode_on_gpu_yields_pinned_views(stream_batches, rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # two data rows on the first card: each row's copy into its slice, from its own thread
    device = make_mesh(data=2, devices=["cuda:0"] * 2) if rows == 2 else "cuda"
    want = [lt.sharded_qmf_decode_batch(s, device=device) for s in stream_batches]
    for s, w in zip(stream_batches, want):
        np.testing.assert_array_equal(w, lt.sharded_qmf_decode_batch(s, device="cpu"))
    before = dict(tdec.PIXEL_COPY_COUNTS)
    got, snapshots = _held_in_order(stream_batches, device, want)
    for pixels, snap, w in zip(got, snapshots, want):
        assert pixels.dtype == np.uint8 and pixels.shape == (2, 3, 48, 64) and pixels.flags.c_contiguous
        assert torch.from_numpy(pixels).is_pinned()
        np.testing.assert_array_equal(pixels, snap)
        np.testing.assert_array_equal(pixels, w)
    assert tdec.PIXEL_COPY_COUNTS["pinned"] - before["pinned"] == 3
    assert tdec.PIXEL_COPY_COUNTS["host"] == before["host"]
    assert 0 <= tdec.PIXEL_COPY_COUNTS["ready"] - before["ready"] <= 3


@pytest.mark.cuda
def test_pixel_copy_wait_releases_the_gil():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.full((2, 3, 8, 8), 7, dtype=torch.uint8, device="cuda")
    torch.cuda._sleep(1_000_000_000)  # about half a second of the card's clock ahead of the copy
    copy = tdec._PixelCopy(tuple(x.shape), x.dtype, [x.device])
    copy.start(0, x)
    assert not copy.ready()
    stamps, stop = [], threading.Event()

    def tick():
        while not stop.is_set():
            stamps.append(time.perf_counter())
            time.sleep(0.001)

    t = threading.Thread(target=tick)
    t.start()
    t0 = time.perf_counter()
    pixels = copy.wait()
    t1 = time.perf_counter()
    stop.set()
    t.join()
    assert (pixels == 7).all() and t1 - t0 > 0.1
    inside = [s for s in stamps if t0 <= s <= t1]
    gaps = np.diff([t0] + inside + [t1])
    assert gaps.max() < 0.05, gaps.max()  # the ticker ran all through the wait
