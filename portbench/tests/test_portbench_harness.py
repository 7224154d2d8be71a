"""The harness on the CPU: cells resolve by name, `BENCHMARK.json` keeps to
the benchmark's rules, the frozen yardsticks, a dry run's last line, and
what a run may import.

Run from the repository's root: `python -m pytest portbench/tests -q`.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import cells, harness, images
from portbench.roofline import bcd_bound_ms

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
TINY = {"image_size": [128, 128], "batch": 2}


# the four-card cell's files, which BENCHMARK.json does not hold (PERF.md, Open questions)
DP4 = {"name": "clic-q10.encode-dp4", "config": "clic-q10", "traffic": "encode-dp4", "chips": 4}


def tiny(name: str) -> cells.Cell:
    """The cell at a size the CPU runs in a second: 128x128 images (every
    patch stack tall, as at the cells' sizes), 2 a data row, 2 pool batches."""
    cell = cells.resolve(name, workload=DP4 if name == DP4["name"] else None)
    cell.config.update(TINY)
    cell.mix.update(pool=2)
    return cell


def dry_run(name: str, trace: bool = False, seconds: float = 1.0) -> dict:
    cell = tiny(name)
    return harness.run(cell, 2**31 + 11, seconds, trace, ["cpu"] * cell.chips, 0.0, lambda msg: None)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = cells.resolve(name)
    assert cell.mix["kind"] in ("encode", "decode") and cell.mix["sample"] >= 1
    assert set(cell.limits) >= {"unreadable", "unlike_first"}
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in reported


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (ROOT / "portbench" / "mixes" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    cell_names = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= cell_names
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= cell_names
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bcd_bound_is_the_kernel_tables():
    assert bcd_bound_ms(64, 6144, 64, 6, 10) == (pytest.approx(0.0986855, rel=1e-6), "operations")
    assert bcd_bound_ms(128, 1536, 64, 3, 10) == (pytest.approx(0.023637, rel=1e-5), "operations")


def test_pool_is_the_seeds_and_tiles_to_clic_size():
    cfg = cells.resolve("clic-q10.encode").config
    a = images.make_pool(cfg["images"], (64, 80), 3, 2, 2**40 + 3, "cpu")
    b = images.make_pool(cfg["images"], (64, 80), 3, 2, 2**40 + 3, "cpu")
    c = images.make_pool(cfg["images"], (64, 80), 3, 2, 2**40 + 4, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    big = images.crops(cfg["images"]["sources"], (1536, 2048), 2)
    assert big.shape == (2, 3, 1536, 2048) and big.dtype == np.uint8


@pytest.mark.parametrize("name,trace", [("kodak-q10.encode", False), ("kodak-q10.decode", True)])
def test_dry_run_result_line(capsys, name, trace):
    from portbench import run

    run.report(dry_run(name, trace))
    out, err = capsys.readouterr()
    result = json.loads(out.splitlines()[-1])
    assert err.splitlines()[-len(result["checks"]):] == [
        line for line in err.splitlines() if line.startswith("check ")]
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert set(keys) - {"correct", "attempted", "failed", "metrics", "device", "checks"} <= {"breakdown"}
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def test_imports_stay_off_jax_and_the_reference_off_the_program():
    modules = sorted(p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
                     for p in (ROOT / "portbench").rglob("*.py") if "metrics" not in p.parts and p.name != "conftest.py")
    code = (
        "import sys, importlib; sys.path.insert(0, %r)\n"
        "import portbench.reference.codec, portbench.reference.compare\n"
        "assert not any(m.split('.')[0] == 'lrf_tpu_torch' for m in sys.modules), 'reference imports the program'\n"
        "for m in %r: importlib.import_module(m)\n"
        "import lrf_tpu_torch.parallel.encode, lrf_tpu_torch.parallel.decode, lrf_tpu_torch.ops.bcd_kernel\n"
        "from portbench import cells\n"
        "for w in cells.benchmark()['workloads']:\n"
        "    c = cells.resolve(w['name'])\n"
        "    [c.reader(m['name']) for m in c.end_to_end + c.per_layer]\n"
        "from portbench.harness import forbidden_modules\n"
        "print(forbidden_modules())\n"
    ) % (str(ROOT), modules)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_prints_no_result_without_the_cards():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for a host without the cell's cards")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "kodak-q10.encode", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
