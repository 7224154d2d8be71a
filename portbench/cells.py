"""Cells by name: what `BENCHMARK.json` and the files beside this one say.

A cell (`workloads` entry) names a configuration and a traffic mix. Each is
a file of its own, found by name: the configuration's `file` as
`BENCHMARK.json` gives it, `mixes/<traffic>.json`, `limits/<cell>.json` (the
limits of the numbers that decide `correct`) and `metrics/<name>.py` for
each per-layer metric (a module with one function, `read(ctx)`, returning
a number or None). Adding a cell, a mix or a metric adds files and edits
none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1

    def reader(self, metric: str):
        """The `read(ctx)` function of `metrics/<metric>.py`."""
        path = HERE / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT, workload: dict | None = None) -> Cell:
    """The cell `name` of `BENCHMARK.json` with its files loaded; `workload`
    stands in for the entry of a cell whose files are here but which
    `BENCHMARK.json` does not hold."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload is not None:
        cells[name] = workload
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(HERE / "mixes" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        mix=mix,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )
