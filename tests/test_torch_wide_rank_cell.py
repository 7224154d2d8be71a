"""The `kodak-q40.encode` cell: Kodak photos at quality 40, where the Y
stack takes rank 26 (the wide cluster kernel on a card) and Cb/Cr rank 13.

On the CPU, at 128x128 (the ranks are Kodak's, 26, 13, 13, and every patch
stack is tall, as at 512x768):
- the port's q40 streams parse with the cell's metadata, and every factor
  entry equals the benchmark's plain reference (`portbench/reference`);
- the bfloat16 control, read as `portbench/calibrate.py` reads it on a small
  copy of the cell, breaks the cell's limits while the port keeps them;
- under a profiler each batch records one `lrf.encode.bcd.launch` per stack,
  routed to the plain version on the CPU, with the stacks' shapes, under the
  batch's `lrf.encode.bcd`; without one nothing records and the streams are
  the same;
- `bcd_wide_roofline_pct` and `deflate_kernel_ms` give hand-worked numbers
  on a built context, and nothing where no such launch was recorded;
- the cell resolves to its files and its two BCD launch shapes.

On the card (`cuda`: `python -m pytest --noconftest -m cuda
tests/test_torch_wide_rank_cell.py`): 4 Kodak-size images at q40 through the
pipeline, within the cell's limits against the reference, the Y stack on
`bcd_cluster_wide`, the chroma on `bcd_cluster`, and the DEFLATE launch
spans covering every fiber.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lrf_tpu_torch.ops import bcd_kernel
from lrf_tpu_torch.parallel.encode import sharded_qmf_encode_batches
from lrf_tpu_torch.utils import profiling
from portbench import calibrate, cells, harness, images
from portbench.reference import compare
from portbench.roofline import bcd_bound_ms
from portbench.trace import Summary

CELL = "kodak-q40.encode"
SMALL = (128, 128)
SEED = 2**33 + 19
# (B, M, N, R) of a batch of 3 at 128x128, q40: Y, then the merged Cb+Cr
SMALL_SHAPES = [(3, 256, 64, 26), (6, 64, 64, 13)]


def _cell(size=SMALL, batch: int = 2, pool: int = 2) -> cells.Cell:
    cell = cells.resolve(CELL)
    cell.config.update(image_size=list(size), batch=batch)
    cell.mix.update(pool=pool)
    return cell


def _pool(cell: cells.Cell, seed: int = SEED, device="cpu") -> list:
    cfg = cell.config
    return images.make_pool(cfg["images"], tuple(cfg["image_size"]), int(cfg["batch"]), int(cell.mix["pool"]), seed,
                            device)


def _encode(cell: cells.Cell, pool: list, device="cpu") -> list:
    return list(sharded_qmf_encode_batches(pool, device=device, **harness._encoder_args(cell.config)))


def test_cell_resolves_to_its_files_and_launch_shapes():
    cell = cells.resolve(CELL)
    assert cell.chips == 1 and cell.mix["kind"] == "encode"
    assert cell.config["quality"] == 40 and cell.config["image_size"] == [512, 768] and cell.config["batch"] == 64
    q10 = cells.resolve("kodak-q10.encode").config
    assert {k for k in q10 if q10[k] != cell.config[k]} == {"name", "quality", "source", "deployment", "assumed"}
    assert harness._launch_shapes(cell.config, 64, 1) == [(64, 6144, 64, 26), (128, 1536, 64, 13)]
    assert {"bcd_wide_roofline_pct", "deflate_kernel_ms"} <= {m["name"] for m in cell.per_layer}
    assert {m["name"] for m in cell.end_to_end} == {"encode_mpix_s", "bpp", "setup_s"}


def test_streams_equal_the_reference_at_kodak_ranks():
    cell = _cell(batch=4, pool=1)
    pool = _pool(cell)
    streams = _encode(cell, pool)
    got, bad = compare.parse_batch(streams[0], cell.config, SMALL)
    assert bad == 0 and [f.shape[-1] for f in got] == [26, 26, 13, 13, 13, 13]
    numbers = compare.encode_numbers(dict(enumerate(streams)), pool, cell.config, "cpu")
    assert numbers == {"unreadable": 0, "apart_mean": 0.0, "apart_worst": 0.0}


@pytest.mark.parametrize("control", [False, True], ids=["port", "bfloat16"])
def test_limits_fail_the_control_and_keep_the_port(control):
    cell = _cell()
    numbers = calibrate.readings(cell, SEED, ["cpu"], control)
    numbers.setdefault("unlike_first", 0)
    correct, checks = compare.judge(numbers, cell.limits)
    assert correct is not control, checks
    if control:
        assert numbers["apart_mean"] > cell.limits["apart_mean"] or numbers["apart_worst"] > cell.limits["apart_worst"]


def _traced_encode(batches):
    profiling.snapshot(clear=True)
    with profile(activities=[ProfilerActivity.CPU]):
        streams = list(sharded_qmf_encode_batches(batches, device="cpu", quality=40))
    profiling.follow_profiler()  # off again
    return streams, profiling.snapshot(clear=True)


def test_launch_spans_name_route_and_shape_per_batch():
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, (3, 3) + SMALL, dtype=np.uint8) for _ in range(2)]
    streams, spans = _traced_encode(batches)
    by_id = {s.id: s for s in spans}
    launches = [s for s in spans if s.name == bcd_kernel.LAUNCH_SPAN]
    assert sorted(s.batch for s in launches) == [0, 0, 1, 1]
    for seq in (0, 1):
        mine = [s for s in launches if s.batch == seq]
        assert [s.attrs for s in mine] == [{"route": "reference", "shape": shape} for shape in SMALL_SHAPES]
        assert {by_id[s.parent].name for s in mine} == {"lrf.encode.bcd"}
        assert all(by_id[s.parent].start_ns <= s.start_ns <= s.end_ns <= by_id[s.parent].end_ns for s in mine)
    assert not [s for s in spans if s.name == "lrf.encode.deflate.launch"]  # no DEFLATE on the CPU

    plain = list(sharded_qmf_encode_batches(batches, device="cpu", quality=40))
    assert profiling.snapshot() == [] and not profiling._REC.on
    assert plain == streams


T0 = 1000.0  # the traced part, 1000 s to 1005 s on perf_counter
WIDE_NAME = "void (anonymous namespace)::bcd_cluster_kernel<26>(float const*, float*, float*, int, int, int, int, " \
            "float, float)"
NARROW_NAME = WIDE_NAME.replace("<26>", "<13>")
DEFLATE_NAME = "(anonymous namespace)::deflate_fibers_kernel((anonymous namespace)::Params)"


def _span(name, sid, parent, batch, at_s, attrs=None):
    ns = int((T0 + at_s) * 1e9)
    return profiling.Span(name, sid, parent, batch, 1, "t", ns, ns + 1000, attrs=attrs)


def _ctx(kernels, kind="encode", traced=True):
    trace = Summary(5.0, {0: 1.0}, {}, {}, kernels) if traced else None
    return harness.Context(kind, 1.0, 30.0, T0 - 9.0, T0 + 21.0, [], ["cuda:0"], {"num_iters": 10}, {},
                           trace=trace, traced=(T0, T0 + 5.0) if traced else None)


def _q40_spans():
    """Two q40 batches in the traced part (one wide and one narrow launch each,
    three DEFLATE launches under one `lrf.encode.deflate` each) and one before it."""
    out, sid = [], 100
    for batch, at in ((7, -0.5), (8, 0.1), (9, 0.2)):
        out.append(_span("lrf.encode.bcd.launch", sid, 10 + batch, batch, at,
                         {"route": "bcd_cluster_wide", "shape": (64, 6144, 64, 26)}))
        out.append(_span("lrf.encode.bcd.launch", sid + 1, 10 + batch, batch, at,
                         {"route": "bcd_cluster", "shape": (128, 1536, 64, 13)}))
        for k, (m, fibers) in enumerate(((6144, 1664), (1536, 1664), (64, 3328))):
            out.append(_span("lrf.encode.deflate.launch", sid + 2 + k, 50 + batch, batch, at + 0.01,
                             {"M": m, "fibers": fibers}))
        sid += 10
    return out


def _read(metric, ctx):
    return cells.resolve(CELL).reader(metric)(ctx)


def test_readers_give_the_hand_worked_numbers(monkeypatch):
    assert bcd_bound_ms(64, 6144, 64, 26, 10) == (pytest.approx(0.550982, rel=1e-5), "operations")
    spans = _q40_spans()
    monkeypatch.setattr(profiling, "snapshot", lambda clear=False: list(spans))
    # two wide launches in the traced part, 3.5 ms of device time each, beside the narrow kernel's
    kernels = [(WIDE_NAME, 0.0035), (WIDE_NAME, 0.0035), (NARROW_NAME, 0.0008), (NARROW_NAME, 0.0008),
               (DEFLATE_NAME, 0.012), (DEFLATE_NAME, 0.009), (DEFLATE_NAME, 0.004), (DEFLATE_NAME, 0.011),
               (DEFLATE_NAME, 0.0095), (DEFLATE_NAME, 0.0045), ("Memcpy DtoH", 0.5)]
    ctx = _ctx(kernels)
    assert _read("bcd_wide_roofline_pct", ctx) == pytest.approx(100 * 2 * 0.550982 / 7.0, rel=1e-5)
    assert _read("deflate_kernel_ms", ctx) == pytest.approx(50.0 / 2, rel=1e-12)
    for metric in ("bcd_wide_roofline_pct", "deflate_kernel_ms"):
        assert _read(metric, _ctx(kernels, kind="decode")) is None
        assert _read(metric, _ctx(kernels, traced=False)) is None


def test_readers_find_nothing_where_no_launch_was_recorded(monkeypatch):
    # a q10 batch: narrow launches only, and the DEFLATE's
    q10 = [s for s in _q40_spans() if (s.attrs or {}).get("route") != "bcd_cluster_wide"]
    for s in q10:
        if s.name == "lrf.encode.bcd.launch":
            s.attrs = {"route": "bcd_cluster", "shape": (64, 6144, 64, 6)}
    monkeypatch.setattr(profiling, "snapshot", lambda clear=False: list(q10))
    kernels = [(NARROW_NAME.replace("<13>", "<6>"), 0.0005), (DEFLATE_NAME, 0.007)]
    assert _read("bcd_wide_roofline_pct", _ctx(kernels)) is None
    assert _read("deflate_kernel_ms", _ctx(kernels)) == pytest.approx(3.5)
    # a program whose spans carry no launches (the parent of this cell), or that keeps no spans
    plain = [profiling.Span("lrf.encode.bcd", 1, None, 0, 1, "t", int(T0 * 1e9) + 5, int(T0 * 1e9) + 9)]
    monkeypatch.setattr(profiling, "snapshot", lambda clear=False: list(plain))
    for metric in ("bcd_wide_roofline_pct", "deflate_kernel_ms"):
        assert _read(metric, _ctx(kernels)) is None
    monkeypatch.delattr(profiling, "snapshot")
    for metric in ("bcd_wide_roofline_pct", "deflate_kernel_ms"):
        assert _read(metric, _ctx(kernels)) is None


@pytest.mark.cuda
def test_card_pipeline_keeps_the_cells_limits_on_the_wide_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the cluster kernels have no CPU mode)")
    from lrf_tpu_torch.ops import deflate

    cell = _cell(size=(512, 768), batch=4, pool=1)
    pool = _pool(cell, device="cuda")
    _encode(cell, pool, device="cuda")  # builds and warms
    before = dict(bcd_kernel.KERNEL.counts)
    profiling.snapshot(clear=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        streams = _encode(cell, pool, device="cuda")
    profiling.follow_profiler()
    spans = profiling.snapshot(clear=True)
    counts = {k: bcd_kernel.KERNEL.counts[k] - before[k] for k in before}
    assert counts == {"bcd_cluster": 1, "bcd_cluster_wide": 1, "bcd_grid": 0, "bcd": 0}
    routes = [s.attrs for s in spans if s.name == bcd_kernel.LAUNCH_SPAN]
    assert routes == [{"route": "bcd_cluster_wide", "shape": (4, 6144, 64, 26)},
                      {"route": "bcd_cluster", "shape": (8, 1536, 64, 13)}]
    fibers = {}
    for s in spans:
        if s.name == deflate.LAUNCH_SPAN:
            fibers[s.attrs["M"]] = fibers.get(s.attrs["M"], 0) + s.attrs["fibers"]
            assert s.bytes_in == s.attrs["M"] * s.attrs["fibers"]
    assert fibers == {6144: 4 * 26, 1536: 2 * 4 * 13, 64: 4 * 26 + 2 * 4 * 13}
    numbers = compare.encode_numbers(dict(enumerate(streams)), pool, cell.config, "cuda")
    numbers["unlike_first"] = 0
    correct, checks = compare.judge(numbers, cell.limits)
    assert correct, checks
