"""The span recorder of `lrf_tpu_torch/utils/profiling.py` in the pipelines.

On the CPU here:
- with no profiler, a pipelined encode of 3 batches and a decode of 2
  record nothing, and give the bytes and pixels of the same calls made
  under `torch.profiler`;
- under a CPU profiler on the calling thread every span the CPU path
  reaches is recorded once per batch, with batch ids 0..n-1; the
  serializer's and the inflate's spans sit on worker threads with their
  parent set; each child lies inside its parent (a worker's span starts
  after it); the mirrored spans, and only they, are in `prof.events()`
  under their names, inside the recorder's spans after the clock
  conversion, their starts within 200 us of the recorder's in the median;
- a data mesh's rows record `lrf.mesh.row` under the batch, and their
  eighs are not mirrored (no profiler runs on a row's thread);
- `lt.trace()` writes the worker threads' spans into its Chrome trace, on
  its clock;
- each `lrf.decode.to_host` span carries the `pinned` and `ready`
  attributes of its batch's pixel copy (on the card too);
- each `lrf.encode.upload` span carries `pinned` (a staged upload to a
  card) and each `lrf.encode.init.gram_fetch` span of the run-ahead
  pipeline `ready` (its Grams were on the host before the wait), on the
  card too.

On the card (`cuda`: `python -m pytest --noconftest -m cuda
tests/test_torch_tracing.py`): the same pipelines' spans on the card's
trace, no device event named after a span, and the mirrors' starts.
"""

import json
import statistics
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lrf_tpu_torch as lt
from lrf_tpu_torch.parallel.decode import sharded_qmf_decode_batches
from lrf_tpu_torch.parallel.encode import sharded_qmf_encode_batches
from lrf_tpu_torch.parallel.mesh import make_mesh
from lrf_tpu_torch.utils import profiling

ENCODE = (
    "lrf.encode.batch", "lrf.encode.upload", "lrf.encode.frontend", "lrf.encode.gram", "lrf.encode.init",
    "lrf.encode.init.gram_fetch",
    "lrf.encode.init.eigh", "lrf.encode.bcd", "lrf.encode.fetch_start", "lrf.encode.fetch_wait",
    "lrf.encode.serializer_queue", "lrf.encode.serialize", "lrf.encode.result_wait",
)
DECODE = (
    "lrf.decode.batch", "lrf.decode.inflate", "lrf.decode.parse", "lrf.decode.inflate_wait", "lrf.decode.device",
    "lrf.decode.upload", "lrf.decode.reconstruct", "lrf.decode.to_host",
)
WORKER = {"lrf.encode.serializer_queue", "lrf.encode.serialize", "lrf.decode.inflate", "lrf.decode.parse"}
# Spans that start once their parent handed them on, and may end after it.
AFTER_PARENT = {"lrf.encode.serializer_queue", "lrf.encode.serialize", "lrf.encode.result_wait"}
MIRRORED = {"lrf.encode.init.eigh", "lrf.encode.fetch_wait", "lrf.encode.result_wait", "lrf.decode.inflate_wait"}


def _batches(n: int, b: int = 2, size=(128, 128)):
    # 128 x 128: every stack is tall (chroma M = 64), so one shared eigh a batch
    rng = np.random.default_rng(17)
    return [rng.integers(0, 256, (b, 3) + size, dtype=np.uint8) for _ in range(n)]


def _run(device, activities):
    """A pipelined encode of 3 batches and a decode of 2 of their answers
    under `torch.profiler`; the recorder's spans of those calls alone."""
    batches = _batches(3)
    profiling.snapshot(clear=True)
    with profile(activities=activities) as prof:
        streams = list(sharded_qmf_encode_batches(batches, device=device, quality=10))
        pixels = list(sharded_qmf_decode_batches(streams[:2], device=device))
    profiling.follow_profiler()  # off again: no profiler runs now
    return prof, streams, pixels, profiling.snapshot(clear=True)


@pytest.fixture(scope="module")
def traced():
    prof, streams, pixels, spans = _run("cpu", [ProfilerActivity.CPU])
    return prof, streams, pixels, spans, threading.get_native_id()


def test_no_profiler_records_nothing_and_changes_no_output(traced):
    _, streams, pixels, _, _ = traced
    profiling.snapshot(clear=True)
    plain = list(sharded_qmf_encode_batches(_batches(3), device="cpu", quality=10))
    plain_pixels = list(sharded_qmf_decode_batches(plain[:2], device="cpu"))
    assert profiling.snapshot() == [] and not profiling._REC.on
    assert plain == streams
    for a, b in zip(plain_pixels, pixels, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("names,n", [(ENCODE, 3), (DECODE, 2)], ids=["encode", "decode"])
def test_each_span_once_per_batch(traced, names, n):
    spans = traced[3]
    assert {s.name for s in spans} >= set(names)
    for name in names:
        assert sorted(s.batch for s in spans if s.name == name) == list(range(n)), name


def test_worker_spans_sit_on_other_threads_with_their_parent(traced):
    spans, main = traced[3], traced[4]
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name in WORKER:
            assert s.thread != main and s.parent in by_id, s
        else:
            assert s.thread == main, s
    for s in spans:
        if s.name in ("lrf.encode.serialize", "lrf.encode.serializer_queue", "lrf.decode.inflate"):
            root = by_id[s.parent]
            assert root.name.endswith(".batch") and root.batch == s.batch and root.thread == main


def test_each_child_lies_inside_its_parent(traced):
    spans = traced[3]
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns, s
        if s.parent is None:
            assert s.name.endswith(".batch"), s
            continue
        p = by_id[s.parent]
        assert p.batch == s.batch and p.start_ns <= s.start_ns, (p, s)
        if s.name not in AFTER_PARENT:
            assert s.end_ns <= p.end_ns, (p, s)
    parents = {by_id[s.parent].name for s in spans if s.name in ("lrf.encode.init.eigh", "lrf.encode.init.gram_fetch")}
    assert parents == {"lrf.encode.init"}
    assert {by_id[s.parent].name for s in spans if s.name == "lrf.decode.parse"} == {"lrf.decode.inflate"}


def _mirrors_match(prof, spans, main, tolerance_us=200.0):
    """Each mirrored span and its profiler event, matched in order: the
    event lies inside the span, which stamps its start before entering the
    `record_function` and its end after leaving it, to within
    `tolerance_us` of clock error on either side; and the starts lie
    within `tolerance_us` of each other in the median. A single start may
    lie further in: a thread that takes the GIL between the two stamps
    delays the profiler's by milliseconds."""
    start_ns = profiling._trace_start_ns(prof)
    events = [e for e in prof.events() if e.name.startswith("lrf.")]
    assert {e.name for e in events} == MIRRORED
    assert {s.name for s in spans if s.mirrored} == MIRRORED
    gaps = []
    for name in MIRRORED:
        evs = sorted((e for e in events if e.name == name), key=lambda e: e.time_range.start)
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        assert len(evs) == len(mine) and all(s.mirrored and s.thread == main for s in mine)
        for e, s in zip(evs, mine):
            start, stop = profiling.profiler_us(s.start_ns, start_ns), profiling.profiler_us(s.end_ns, start_ns)
            assert e.thread == evs[0].thread
            assert start - tolerance_us <= e.time_range.start and e.time_range.end <= stop + tolerance_us, (e, s)
            gaps.append(abs(e.time_range.start - start))
    assert statistics.median(gaps) < tolerance_us, gaps


def test_mirrored_spans_are_the_profilers_own(traced):
    prof, _, _, spans, main = traced
    _mirrors_match(prof, spans, main)


def test_mesh_rows_record_under_the_batch():
    mesh = make_mesh(data=2, devices=["cpu"] * 2)
    profiling.snapshot(clear=True)
    with profile(activities=[ProfilerActivity.CPU]):
        list(sharded_qmf_encode_batches(_batches(2), device=mesh, quality=10))
    profiling.follow_profiler()
    spans = profiling.snapshot(clear=True)
    by_id = {s.id: s for s in spans}
    rows = [s for s in spans if s.name == "lrf.mesh.row"]
    assert sorted((s.batch, s.row) for s in rows) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    main = threading.get_native_id()
    for s in rows:
        root = by_id[s.parent]
        assert root.name == "lrf.encode.batch" and s.thread != main
        assert root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
    eighs = [s for s in spans if s.name == "lrf.encode.init.eigh"]
    assert len(eighs) == 4 and not any(s.mirrored for s in eighs)
    assert all(by_id[by_id[s.parent].parent].name == "lrf.mesh.row" for s in eighs)
    assert sum(s.name == "lrf.encode.upload" for s in spans) == 2


def test_trace_writes_worker_spans_on_its_clock(tmp_path):
    with lt.trace(str(tmp_path)):
        list(sharded_qmf_encode_batches(_batches(2), device="cpu", quality=10))
    assert not profiling._REC.on
    events = json.loads(next(tmp_path.iterdir()).read_text())["traceEvents"]
    main = threading.get_native_id()
    mine = [e for e in events if e.get("cat") == "lrf"]
    serialize = [e for e in mine if e["name"] == "lrf.encode.serialize"]
    assert len(serialize) == 2 and all(e["tid"] != main and e["ph"] == "X" for e in serialize)
    names = {e["tid"]: e["args"]["name"] for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert all(names[e["tid"]].startswith("ThreadPoolExecutor") for e in serialize)
    # batches overlap on the calling thread: async events there
    assert sorted(e["ph"] for e in mine if e["name"] == "lrf.encode.batch").count("b") >= 1
    # the profiler's own mirror of each eigh lies inside the recorder's init span
    inits = sorted((e for e in mine if e["name"] == "lrf.encode.init"), key=lambda e: e["ts"])
    eighs = sorted((e for e in events if e.get("name") == "lrf.encode.init.eigh"), key=lambda e: e["ts"])
    assert len(inits) == len(eighs) == 2
    assert all(e.get("cat") != "lrf" for e in eighs)
    for i, e in zip(inits, eighs):
        assert i["tid"] == e["tid"] == main
        assert i["ts"] <= e["ts"] and e["ts"] + e["dur"] <= i["ts"] + i["dur"]


def test_snapshot_clear_and_bound():
    rec = profiling._Recorder(4)
    for k in range(6):
        s = rec.new(f"s{k}", None, k, None, None)
        s.end_ns = s.start_ns
        rec.keep(s)
    assert [s.name for s in rec.snapshot(clear=True)] == ["s2", "s3", "s4", "s5"]
    assert rec.snapshot(clear=False) == []


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_to_host_spans_carry_the_copy_attrs(traced, device):
    spans = traced[3]
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        profiling.snapshot(clear=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            list(sharded_qmf_decode_batches(traced[1][:2], device="cuda"))  # the CPU's streams
        profiling.follow_profiler()
        spans = profiling.snapshot(clear=True)
    to_host = [s for s in spans if s.name == "lrf.decode.to_host"]
    assert len(to_host) == 2
    for s in to_host:
        assert set(s.attrs) == {"pinned", "ready"}, s
        assert s.attrs["pinned"] is (device == "cuda") and isinstance(s.attrs["ready"], bool), s
        assert s.attrs["ready"] or device == "cuda", s  # CPU pixels never wait


@pytest.mark.cuda
def test_card_spans_fake_no_device_time():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the BCD kernel has no CPU mode)")
    prof, _, _, spans = _run("cuda", [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert device and not [e.name for e in device if e.name.startswith("lrf.")]
    assert {s.name for s in spans} >= set(ENCODE) | set(DECODE)
    _mirrors_match(prof, spans, threading.get_native_id())


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_upload_and_gram_fetch_spans_carry_their_attrs(traced, device):
    spans = traced[3]
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device and nvcc (the BCD kernel has no CPU mode)")
        profiling.snapshot(clear=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            list(sharded_qmf_encode_batches(_batches(3), device="cuda", quality=10))
        profiling.follow_profiler()
        spans = profiling.snapshot(clear=True)
    uploads = [s for s in spans if s.name == "lrf.encode.upload"]
    fetches = [s for s in spans if s.name == "lrf.encode.init.gram_fetch"]
    assert len(uploads) == len(fetches) == 3
    for s in uploads:
        assert s.attrs == {"pinned": device == "cuda"}, s
    for s in fetches:
        assert set(s.attrs) == {"ready"} and isinstance(s.attrs["ready"], bool), s
        assert s.attrs["ready"] or device == "cuda", s  # CPU Grams never wait


def test_gram_ready_pct_reads_the_ready_fetches(monkeypatch):
    # The benchmark's `gram_ready_pct` on recorder contents worked out by
    # hand: of the traced part's gram fetches that carry `ready`, the share
    # that is true; nothing to read without such spans or outside an
    # encode cell's traced run.
    from portbench import cells
    from portbench.harness import Context
    from portbench.trace import Summary

    t0 = 1000.0  # the traced part, 1000 s to 1005 s on perf_counter

    def fetch(at_s, ready=None):
        ns = int(at_s * 1e9)
        attrs = None if ready is None else {"ready": ready}
        return profiling.Span("lrf.encode.init.gram_fetch", 1, None, 0, 1, "t", ns, ns + 1000, attrs=attrs)

    spans = [fetch(t0 + 0.1, True), fetch(t0 + 0.2, True), fetch(t0 + 0.3, False), fetch(t0 + 0.4, True),
             fetch(t0 - 1.0, False), fetch(t0 + 0.5)]  # one before the traced part, one without the attribute
    read = cells.Cell.reader(None, "gram_ready_pct")

    def ctx(kind="encode", traced=True):
        trace = Summary(5.0, {0: 1.0}, {}, {}, []) if traced else None
        return Context(kind, 1.0, 30.0, t0 - 9.0, t0 + 21.0, [], ["cuda:0"], {}, {}, trace=trace,
                       traced=(t0, t0 + 5.0) if traced else None)

    monkeypatch.setattr(profiling, "snapshot", lambda clear=False: list(spans))
    assert read(ctx()) == 75.0
    assert read(ctx("decode")) is None and read(ctx(traced=False)) is None
    spans[:4] = []
    assert read(ctx()) is None  # no fetch in the traced part carries `ready`, as before the run-ahead schedule
