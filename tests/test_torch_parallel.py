"""The port's batched codec host tail against the JAX package's.

- The one transport: the batch's streams equal per-image `qmf_encode` on
  the CPU, and the fetched raw factors serialize to them; any other pack
  or decode upload is refused.
- `_serialize_batch` on the fetched factors gives the streams that the JAX
  package's host tail gives from its own raw, flat and entropy buffers of
  the same factors, under each fiber coder, and the plain pure-Python
  serializer's under "zlib".
- The pipelined encoder gives the one-shot streams, in order, across image
  sizes, at depths 1 and 2.
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


def _host_buffers(images):
    """Fetched host buffers of one CPU encode (the raw factors), its spec
    and its metadata."""
    b = images.shape[0]
    fn, metadata, spec = tenc.build_sharded_encoder("cpu", images.shape[-2:], batch=b, **KW)
    return tenc._fetch_encoded(HostCopy(fn(torch.from_numpy(images))), spec), spec, metadata


def test_transports_give_identical_streams(batch):
    # One transport: the batch's streams are per-image `qmf_encode`'s, and
    # the fetched raw factors serialize to them.
    raw = lt.sharded_qmf_encode_batch(batch, device="cpu", **KW)
    assert raw == [lt.qmf_encode(img, device="cpu", **KW) for img in batch]
    host, spec, metadata = _host_buffers(batch)
    assert spec is None and [f.dtype for f in host] == [np.int8] * 6
    assert tenc._serialize_batch(host, spec, metadata, batch.shape[0]) == raw
    assert lt.sharded_qmf_encode_batch(batch, device="cpu", pack=None, **KW) == raw  # the benchmark's keyword


@pytest.fixture(scope="module")
def jax_buffers(batch):
    """`jax_buffers(pack)`: the JAX package's fetched host buffers of its
    `pack` transport (None, "flat" or "entropy") for the port's raw factors
    of `batch`, made by its own packers, with its pack spec and metadata."""
    import jax
    import jax.numpy as jnp
    from lrf_tpu.ops.entropy import pack_segments
    from lrf_tpu.parallel import encode as jenc
    from lrf_tpu.parallel.mesh import make_mesh

    host, _, _ = _host_buffers(batch)
    mesh = make_mesh(data=1, patch=1, devices=jax.devices()[:1])
    made = {}

    def buffers(pack):
        if pack not in made:
            _, metadata, spec = jenc.build_sharded_encoder(
                mesh, batch.shape[-2:], batch=batch.shape[0], pack=pack or False, **KW
            )
            factors = [jnp.asarray(f) for f in host]
            if pack == "flat":
                factors = jenc._pack_factors(factors, spec["lo"], spec["bits"])
            elif pack == "entropy":
                seg_base, main, exc = pack_segments(factors, max_exc_rows=spec["exc_budget"])
                factors = (jnp.concatenate([seg_base.astype(jnp.uint32), main, exc]),)
            made[pack] = jenc._fetch_encoded(factors, spec), spec, metadata
        return made[pack]

    return buffers


@pytest.mark.parametrize("coder", ["zlib", "best", "deflate"])
@pytest.mark.parametrize("jax_pack", [None, "flat", "entropy"])
def test_serialize_batch_matches_jax(batch, coders, jax_buffers, jax_pack, coder):
    # The port's one transport against each of the JAX package's: the same
    # factors through both host tails give the same streams.
    from lrf_tpu.native import fibercodec as jnative
    from lrf_tpu.parallel import encode as jenc

    if not jnative.available():
        pytest.skip("the JAX package's native fiber coder does not load here")
    if coder == "deflate" and "deflate" not in tnative.backends():
        pytest.skip("the port's native coder was built without libdeflate")
    jc = coders
    b = batch.shape[0]
    host, spec, metadata = _host_buffers(batch)
    j_host, j_spec, j_metadata = jax_buffers(jax_pack)
    assert j_metadata == metadata
    jc.set_fiber_coder(coder)
    tc.set_fiber_coder(coder)
    got = tenc._serialize_batch(host, spec, metadata, b)
    assert got == jenc._serialize_batch(j_host, j_spec, j_metadata, b)
    if coder == "zlib":
        assert got == tenc._serialize_plain(host, metadata, b)


@pytest.mark.parametrize(
    "kw", [{"pack": "flat"}, {"pack": True}, {"pack": "entropy"}, {"transport": "dpack"}],
    ids=["pack=flat", "pack=True", "pack=entropy", "transport=dpack"],
)
def test_other_transports_are_refused(batch, kw):
    # One transport each way: any other pack or decode upload raises, as an
    # unknown one always did.
    if "pack" in kw:
        for call in (lambda **k: lt.sharded_qmf_encode_batch(batch, device="cpu", **k, **KW),
                     lambda **k: lt.build_sharded_encoder("cpu", (48, 64), **k, **KW)):  # without a batch too
            with pytest.raises(ValueError, match="one transport"):
                call(**kw)
            with pytest.raises(ValueError, match="lz4"):
                call(pack="lz4")
    else:
        streams = lt.sharded_qmf_encode_batch(batch, device="cpu", **KW)
        for transport in (kw["transport"], "huffman"):
            with pytest.raises(ValueError, match="transport"):
                lt.sharded_qmf_decode_batch(streams, device="cpu", transport=transport)
            with pytest.raises(ValueError, match="transport"):
                next(lt.sharded_qmf_decode_batches([streams], device="cpu", transport=transport))


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_encode_matches_one_shot(batch, depth):
    small = np.ascontiguousarray(batch[:3, :, :32, :40])
    batches = [batch, small, batch[::-1].copy(), small]
    want = [lt.sharded_qmf_encode_batch(x, device="cpu", **KW) for x in batches]
    got = list(lt.sharded_qmf_encode_batches(batches, device="cpu", depth=depth, **KW))
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

    host, spec, metadata = _host_buffers(batch)
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
    want = [lt.sharded_qmf_encode_batch(x, quality=10) for x in batches]
    for depth in (1, 3):
        assert list(lt.sharded_qmf_encode_batches(batches, quality=10, depth=depth)) == want
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
