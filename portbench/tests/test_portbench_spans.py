"""The span metrics on the CPU: each reader of `metrics/` that reads the
program's spans (`portbench/spans.py`), on a synthetic `Context` and
recorder contents, gives the number worked out by hand; it returns None
where its spans, the trace or its cell's kind are absent, or where the
program keeps no spans (as before it recorded any); and a traced dry run
of the decode cell reports its span metrics.

Run from the repository's root: `python -m pytest portbench/tests -q`.
"""

from __future__ import annotations

import json

import pytest

from lrf_tpu_torch.utils import profiling
from portbench import cells
from portbench.harness import Context
from portbench.tests.test_portbench_harness import dry_run
from portbench.trace import Summary

T0 = 1000.0  # the traced part: 1000 s to 1005 s on the host's perf_counter
WINDOW_S = 5.0
IDLE = {"lrf.encode.result_wait": 2.0, "lrf.encode.init.eigh": 0.25, "lrf.decode.inflate_wait": 0.05,
        "aten::copy_": 1.0}
# A span per (name, ms after T0, ms long); the last of each name starts before the traced part.
SPANS = {
    "lrf.encode.result_wait": [(10, 40), (100, 50), (-20, 90)],
    "lrf.encode.init.eigh": [(5, 11), (95, 12)],
    "lrf.encode.serialize": [(1, 60), (50, 90), (120, 70), (4000, 100), (-300, 500)],
    "lrf.encode.serializer_queue": [(1, 2), (50, 30), (-10, 40)],
    "lrf.encode.init": [(3, 15), (93, 16), (180, 21)],
    "lrf.encode.upload": [(0, 14), (90, 16), (-5, 99)],
    "lrf.encode.fetch_wait": [(20, 0.5), (110, 0.25), (200, 0.75), (300, 1.0)],
    "lrf.decode.inflate_wait": [(7, 1)],
    "lrf.decode.inflate": [(2, 12), (45, 13), (-1, 80)],
    "lrf.decode.to_host": [(30, 35), (75, 41), (4990, 38), (5100, 90)],
}
READ = [  # metric, cell kind, expected
    ("idle_on_serializer_pct", "encode", 40.0),
    ("idle_on_eigh_pct", "encode", 5.0),
    ("serialize_span_ms", "encode", 80.0),
    ("serializer_queue_ms", "encode", 16.0),
    ("init_span_ms", "encode", 16.0),
    ("upload_span_ms", "encode", 15.0),
    ("fetch_wait_ms", "encode", 0.625),
    ("idle_on_inflate_pct", "decode", 1.0),
    ("inflate_span_ms", "decode", 12.5),
    ("pixels_to_host_span_ms", "decode", 38.0),
]
SPAN_OF = {"idle_on_serializer_pct": "lrf.encode.result_wait", "idle_on_eigh_pct": "lrf.encode.init.eigh",
           "idle_on_inflate_pct": "lrf.decode.inflate_wait"}


def _ctx(kind: str, idle=None, traced=True) -> Context:
    trace = Summary(WINDOW_S, {0: 1.0}, {}, dict(IDLE if idle is None else idle), []) if traced else None
    return Context(kind, 1.0, 30.0, T0 - 9.0, T0 + 21.0, [], ["cuda:0"], {}, {}, trace=trace,
                   traced=(T0, T0 + WINDOW_S) if traced else None)


@pytest.fixture
def recorder(monkeypatch):
    """The program's recorder holding `SPANS` and nothing else."""
    monkeypatch.setattr(profiling._REC, "on", True)
    profiling.snapshot(clear=True)
    for name, spans in SPANS.items():
        for at_ms, ms in spans:
            start = round(T0 * 1e9 + at_ms * 1e6)
            profiling.record(name, start, start + round(ms * 1e6))
    yield
    profiling.snapshot(clear=True)


def _read(metric: str, ctx):
    return cells.resolve("kodak-q10.encode").reader(metric)(ctx)


@pytest.mark.parametrize("metric,kind,want", READ, ids=[m for m, _, _ in READ])
def test_reader_gives_the_hand_worked_number(recorder, metric, kind, want):
    assert _read(metric, _ctx(kind)) == pytest.approx(want, rel=1e-12)
    assert _read(metric, _ctx("decode" if kind == "encode" else "encode")) is None
    assert _read(metric, _ctx(kind, traced=False)) is None


@pytest.mark.parametrize("metric,kind,want", READ, ids=[m for m, _, _ in READ])
def test_reader_finds_nothing_to_read(monkeypatch, metric, kind, want):
    profiling.snapshot(clear=True)
    assert _read(metric, _ctx(kind)) is None  # no spans
    monkeypatch.delattr(profiling, "snapshot")  # a program that records none
    assert _read(metric, _ctx(kind)) is None


@pytest.mark.parametrize("metric", sorted(SPAN_OF))
def test_idle_share_is_zero_where_no_gap_fell_in_its_spans(recorder, metric):
    kind = "decode" if "inflate" in metric else "encode"
    assert _read(metric, _ctx(kind, idle={"aten::copy_": 1.0})) == 0.0


def test_metrics_name_their_cells():
    bench = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric, kind, _ in READ:
        m = entries[metric]
        want = ["kodak-q10.decode"] if kind == "decode" else ["kodak-q10.encode", "clic-q10.encode"]
        assert m["workloads"] == want and m["better"] == "lower"
        assert m["moves"] == f"{kind}_mpix_s"
        assert m["source"] == ("device_trace" if metric in SPAN_OF else "host_clock")


def test_traced_dry_run_reports_its_span_metrics():
    # the decode cell, 8 s: a CPU encode at the dry run's size answers too late for its traced part,
    # and a loaded CPU takes seconds to start the profiler
    result = dry_run("kodak-q10.decode", trace=True, seconds=8.0)
    want = {m for m, k, _ in READ if k == "decode"}
    assert want <= set(result["metrics"]), sorted(result["metrics"])
    assert all(result["metrics"][m]["value"] >= 0 for m in want)
