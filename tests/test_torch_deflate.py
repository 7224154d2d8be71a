"""The card's zlib level-9 DEFLATE (`lrf_tpu_torch/ops/deflate.py`), its host
twin, the framing of its streams, and when the encoder takes it.

This file imports neither JAX nor `lrf_tpu`, so its `cuda` tests run on a
GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_deflate.py

On the CPU here:
- the host twin (`native/deflate_twin.cpp`, the kernel's match search,
  parse and block coder with plain loops for the chains) gives
  `zlib.compress(fiber, 9)` byte for byte on a corpus: every fiber of real
  factors at M = 64, 1536, 6144, 12288 and 49152 from the CPU encode of
  `portbench/data` photographs, all-zero and constant fibers, seeded random
  bytes (stored blocks), lengths 1, 2, 3, 258 and 259, fibers of more than
  16383 symbols (several blocks), and both sides of the window-slide bound
  (65273 bytes coded, 65274 refused);
- `frame_streams` on the twin's streams, laid out as the kernel lays them,
  gives the host serializer's streams, also through `_serialize_batch`;
- `_card_deflate` takes the card path only for a CUDA device, int8
  factors of a known batch, a coder that gives zlib-9 bytes and fibers
  within the kernel's bound.

On the card (`cuda`): the kernel's streams equal zlib's on the same corpus;
`sharded_qmf_encode_batches` on Kodak-size and CLIC-size batches gives the
host path's streams, with the launches counted and `lrf.encode.deflate`
recorded; "flat", "entropy", the "deflate" coder, the CPU and fibers
over the bound launch nothing; and the kernel asks for a global rank
scratch only where shared memory cannot hold the ranks.
"""

import contextlib
import ctypes
import functools
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import lrf_tpu_torch as lt
from lrf_tpu_torch.native import fibercodec
from lrf_tpu_torch.ops import deflate
from lrf_tpu_torch.parallel import encode as penc

DATA = Path(__file__).resolve().parent.parent / "portbench" / "data"
KODAK = (512, 768)
CLIC = (1536, 2048)


def _photo(name: str, size) -> np.ndarray:
    """`(3, h, w)` uint8: a PNG of portbench/data, reflect-padded to at least
    `size`, then its top-left `size` crop."""
    img = np.asarray(Image.open(DATA / name).convert("RGB")).transpose(2, 0, 1)
    h, w = size
    ph, pw = max(0, h - img.shape[1]), max(0, w - img.shape[2])
    img = np.pad(img, ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)), mode="reflect")
    return np.ascontiguousarray(img[:, :h, :w])


@functools.lru_cache(maxsize=None)
def _factors(size) -> tuple:
    """The six int8 `(1, M, R)` factors of one photograph's CPU encode at q10."""
    name = "kodim01.png" if size == KODAK else "clic_flower.png"
    fn, _, _ = penc.build_sharded_encoder("cpu", size, quality=10)
    return tuple(f.numpy() for f in fn(torch.from_numpy(_photo(name, size)[None])))


def _real(size, k: int) -> list[bytes]:
    f = _factors(size)[k]
    return [np.ascontiguousarray(f[0, :, r]).tobytes() for r in range(f.shape[2])]


def _rng(seed: int):
    return np.random.default_rng(seed)


def _int8(a) -> bytes:
    return np.asarray(a).astype(np.int64).astype(np.int8).tobytes()


# name -> fibers (a function, so that collection stays cheap)
CORPUS = {
    # every fiber of one factor of a real encode: V of Y, Cb's U and Y's U
    # at the Kodak size, Cb's U and Y's U at the CLIC size
    "real-M64": lambda: _real(KODAK, 1),
    "real-M1536": lambda: _real(KODAK, 2),
    "real-M6144": lambda: _real(KODAK, 0),
    "real-M12288": lambda: _real(CLIC, 2),
    "real-M49152": lambda: _real(CLIC, 0),
    "zeros": lambda: [bytes(6144), bytes(49152)],
    "constant": lambda: [b"\x07" * 1000, _int8(np.full(12288, -16))],
    "random-stored": lambda: [_rng(1).integers(0, 256, n, dtype=np.uint8).tobytes() for n in (64, 5000, 40000)],
    "len-1": lambda: [b"\x05"],
    "len-2": lambda: [b"\x05\xfb"],
    "len-3": lambda: [b"\x05\xfb\x05", b"\x00\x00\x00"],
    "len-258": lambda: [_int8(np.arange(258) % 5 - 2), bytes(258)],
    "len-259": lambda: [_int8(np.arange(259) % 5 - 2), bytes(259)],
    # ~30000 literals and short matches: two full blocks of 16383 symbols
    "blocks": lambda: [_int8(_rng(2).integers(-16, 16, 30000)),
                       _int8(np.round(_rng(3).laplace(0, 6, 40000)).clip(-16, 15))],
    "slide-bound": lambda: [_rng(4).integers(0, 256, deflate.MAX_FIBER, dtype=np.uint8).tobytes()],
}


@pytest.mark.parametrize("case", sorted(CORPUS))
def test_twin_is_zlib_9(case):
    for fiber in CORPUS[case]():
        assert deflate.twin_compress(fiber) == zlib.compress(fiber, 9), (case, len(fiber))


def test_twin_refuses_fibers_that_slide_the_window():
    fiber = _rng(4).integers(0, 256, deflate.MAX_FIBER + 1, dtype=np.uint8).tobytes()
    with pytest.raises(ValueError, match="at most 65273"):
        deflate.twin_compress(fiber)
    assert deflate.TWIN.lib().lrf_deflate_twin_max_fiber() == deflate.MAX_FIBER


@contextlib.contextmanager
def _coder(backend, level=None):
    old = lt.get_fiber_coder()
    lt.set_fiber_coder(backend, level)
    try:
        yield
    finally:
        lt.set_fiber_coder(*old)


def _twin_slots(factors):
    """The twin's streams laid out as `deflate_fibers` lays out the kernel's."""
    caps = deflate.slot_caps([f.shape[1] for f in factors])
    slots, lens = [], []
    for f, cap in zip(factors, caps):
        for bi in range(f.shape[0]):
            for r in range(f.shape[2]):
                blob = deflate.twin_compress(np.ascontiguousarray(f[bi, :, r]).tobytes())
                slots.append(blob + bytes(cap - len(blob)))
                lens.append(len(blob))
    return np.frombuffer(b"".join(slots), np.uint8), np.asarray(lens, np.int32), caps


def test_framing_card_streams_gives_the_host_serializers():
    fn, metadata, _ = penc.build_sharded_encoder("cpu", (64, 96), quality=10)
    images = np.stack([_photo("kodim01.png", (64, 96)), _photo("china.png", (64, 96))])
    factors = [f.numpy() for f in fn(torch.from_numpy(images))]
    slots, lens, caps = _twin_slots(factors)
    b, rs = images.shape[0], [f.shape[2] for f in factors]
    spec = {"mode": "zlib9", "shapes": tuple(f.shape for f in factors), "caps": tuple(caps)}
    framed = penc._serialize_batch((slots, lens), spec, metadata, b)
    with _coder("zlib"):
        assert framed == penc._serialize_batch(factors, None, metadata, b)
    assert framed == penc._serialize_plain(factors, metadata, b)
    bad = lens.copy()
    bad[3] = -1
    with pytest.raises(RuntimeError, match="outside its slot"):
        fibercodec.frame_streams(slots, bad, b, rs, caps, b"{}", penc._inner_metadata(rs))


@pytest.mark.parametrize(
    "device,backend,level,backends,dtype,batch,m,want",
    [
        ("cuda", "zlib", 9, ("zlib", "deflate"), np.int8, 64, 6144, True),
        ("cuda", "best", None, ("zlib",), np.int8, 64, 49152, True),  # the card's host: no libdeflate
        ("cuda", "best", None, ("zlib", "deflate"), np.int8, 64, 6144, False),  # the race with libdeflate-12
        ("cuda", "zlib", 6, ("zlib",), np.int8, 64, 6144, False),
        ("cuda", "deflate", None, ("zlib",), np.int8, 64, 6144, False),
        ("cuda", "zlib", 9, ("zlib",), np.int16, 64, 6144, False),
        ("cuda", "zlib", 9, ("zlib",), np.int8, None, 6144, False),
        ("cuda", "zlib", 9, ("zlib",), np.int8, 64, 54001, False),  # over the kernel's bound
        ("cpu", "zlib", 9, ("zlib",), np.int8, 64, 6144, False),
    ],
)
def test_card_path_engages_only_on_zlib_9_bytes(monkeypatch, device, backend, level, backends, dtype, batch, m, want):
    monkeypatch.setattr(penc._native, "backends", lambda: backends)
    monkeypatch.setattr(deflate.KERNEL, "max_fiber", lambda: 54000)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    with _coder(backend, level):
        assert penc._card_deflate(torch.device(device), dtype, batch, [64, m]) is want


def test_cpu_encoder_keeps_the_host_path():
    with _coder("zlib"):
        _, _, spec = penc.build_sharded_encoder("cpu", (64, 96), quality=10, batch=2)
    assert spec is None


# -- on the card ---------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the DEFLATE kernel has no CPU mode)")


def _as_factor(fibers):
    """Equal-length fibers as one int8 (1, n, R) factor."""
    return torch.from_numpy(np.stack([np.frombuffer(f, np.int8) for f in fibers], axis=1)[None].copy())


@pytest.mark.cuda
def test_kernel_streams_are_zlib_9():
    _need_card()
    for case in sorted(CORPUS):
        by_len = {}
        for fiber in [f for f in CORPUS[case]() if len(f) <= deflate.KERNEL.max_fiber()]:
            by_len.setdefault(len(fiber), []).append(fiber)
        if not by_len:
            continue
        fibers = [f for group in by_len.values() for f in group]
        factors = [_as_factor(group).cuda() for group in by_len.values()]
        slots, lens = deflate.deflate_fibers(factors)
        slots, lens = slots.cpu().numpy(), lens.cpu().numpy()
        caps = deflate.slot_caps([f.shape[1] for f in factors])
        offsets = np.concatenate([[0], np.cumsum([c * f.shape[2] for f, c in zip(factors, caps)])])
        at = [int(o) + i * c for f, c, o in zip(factors, caps, offsets) for i in range(f.shape[2])]
        for fiber, a, n in zip(fibers, at, lens.tolist()):
            assert slots[a : a + n].tobytes() == zlib.compress(fiber, 9), (case, len(fiber))
    # the six factors of a real encode in one call: three launches (M = 6144, 1536, 64)
    before = deflate.KERNEL.launches
    factors = [torch.from_numpy(f).cuda() for f in _factors(KODAK)]
    slots, lens = deflate.deflate_fibers(factors)
    assert deflate.KERNEL.launches - before == 3
    framed = fibercodec.frame_streams(slots.cpu().numpy(), lens.cpu().numpy(), 1, [f.shape[2] for f in factors],
                                      deflate.slot_caps([f.shape[1] for f in factors]), b"{}",
                                      penc._inner_metadata([f.shape[2] for f in factors]))
    want = fibercodec.assemble_streams(_factors(KODAK), 1, [f.shape[1] for f in factors],
                                       [f.shape[2] for f in factors], b"{}",
                                       penc._inner_metadata([f.shape[2] for f in factors]), 9, "zlib")
    assert framed == want


def _card_batches(size, b: int, n: int):
    names = sorted(p.name for p in DATA.glob("*.png"))
    return [np.stack([_photo(names[(i * b + j) % len(names)], size) for j in range(b)]) for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("size,b", [(KODAK, 8), (CLIC, 2)])
def test_pipeline_streams_equal_the_host_paths(size, b):
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    from lrf_tpu_torch.utils import profiling

    batches = _card_batches(size, b, 3)
    with _coder("zlib"):
        host = list(penc.sharded_qmf_encode_batches(batches, device="cuda", quality=10, pack="flat"))
        before = deflate.KERNEL.launches
        profiling.snapshot(clear=True)
        with profile(activities=[ProfilerActivity.CPU]):
            card = list(penc.sharded_qmf_encode_batches(batches, device="cuda", quality=10))
        profiling.follow_profiler()
        spans = [s for s in profiling.snapshot(clear=True) if s.name == "lrf.encode.deflate"]
    assert card == host
    assert deflate.KERNEL.launches - before == 3 * len(batches)  # one launch per M: U of Y, U of Cb and Cr, the Vs
    assert len(spans) == len(batches) and not any(s.mirrored for s in spans)
    with _coder("zlib"):
        shapes = penc.build_sharded_encoder("cuda", size, quality=10, batch=b)[2]["shapes"]
    assert all(s.bytes_in == sum(int(np.prod(x)) for x in shapes) > s.bytes_out > 0 for s in spans)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flat", "entropy", "deflate-coder", "cpu", "over-bound"])
def test_routes_off_the_card_launch_nothing(monkeypatch, case):
    _need_card()
    images = _card_batches(KODAK, 4, 1)[0]
    kw, device, coder = {}, "cuda", ("zlib", None)
    if case in ("flat", "entropy"):
        kw["pack"] = case
    elif case == "deflate-coder":
        coder = ("deflate", None)
    elif case == "cpu":
        device = "cpu"
    else:
        deflate.KERNEL.lib()
        monkeypatch.setattr(deflate.KERNEL, "_max_fiber", 6143)  # Y's U has 6144 rows
    before = deflate.KERNEL.launches
    with _coder(*coder):
        streams = lt.sharded_qmf_encode_batch(images, device=device, quality=10, **kw)
        _, _, spec = penc.build_sharded_encoder(device, KODAK, quality=10, batch=4, **kw)
    assert deflate.KERNEL.launches == before
    assert spec is None or spec["mode"] != "zlib9"
    assert len(streams) == 4
    if case == "over-bound":
        with pytest.raises(ValueError, match="exceed"):
            deflate.deflate_fibers([torch.zeros((1, 6144, 1), dtype=torch.int8, device="cuda")])


@pytest.mark.cuda
def test_rank_scratch_only_where_shared_memory_cannot_hold_it():
    _need_card()
    lib = deflate.KERNEL.lib()
    out = ctypes.c_int(-1)
    assert lib.lrf_deflate_global_rank(6144, ctypes.byref(out)) == 0 and out.value == 0
    assert lib.lrf_deflate_global_rank(49152, ctypes.byref(out)) == 0 and out.value == 1


def test_deflate_on_card_pct_reads_the_batches_deflated_on_the_card(monkeypatch):
    from lrf_tpu_torch.utils import profiling
    from portbench import cells
    from portbench.harness import Context
    from portbench.trace import Summary

    t0 = 1000.0  # the traced part, 1000 s to 1005 s on perf_counter

    def span(name, sid, parent, at_s):
        ns = int(at_s * 1e9)
        return profiling.Span(name, sid, parent, 0, 1, "t", ns, ns + 1000)

    # batches 1-3 serialized in the traced part, batch 4 before it, and one
    # taken before the recorder came on (no parent); the card DEFLATEd
    # batches 1 and 2 (one of them before the traced part) and 4
    spans = [span("lrf.encode.deflate", 10, 1, t0 - 0.5), span("lrf.encode.deflate", 11, 2, t0 + 0.1),
             span("lrf.encode.deflate", 12, 4, t0 - 2.0), span("lrf.encode.serialize", 20, 1, t0 + 0.2),
             span("lrf.encode.serialize", 21, 2, t0 + 0.3), span("lrf.encode.serialize", 22, 3, t0 + 0.4),
             span("lrf.encode.serialize", 23, 4, t0 - 1.0), span("lrf.encode.serialize", 24, None, t0 + 0.5)]
    read = cells.Cell.reader(None, "deflate_on_card_pct")

    def ctx(kind="encode", traced=True):
        trace = Summary(5.0, {0: 1.0}, {}, {}, []) if traced else None
        return Context(kind, 1.0, 30.0, t0 - 9.0, t0 + 21.0, [], ["cuda:0"], {}, {}, trace=trace,
                       traced=(t0, t0 + 5.0) if traced else None)

    monkeypatch.setattr(profiling, "snapshot", lambda clear=False: list(spans))
    assert read(ctx()) == pytest.approx(100.0 * 2 / 3)
    assert read(ctx("decode")) is None and read(ctx(traced=False)) is None
    spans[:3] = []
    assert read(ctx()) == 0.0  # the program has the card path, and no batch took it
    monkeypatch.setattr(profiling, "snapshot", lambda clear=False: [])
    assert read(ctx()) is None  # nothing serialized in the traced part
