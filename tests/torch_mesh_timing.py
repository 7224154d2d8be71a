"""The batched QMF encode on one card and on a data mesh over every card.

    python tests/torch_mesh_timing.py [--tree TREE] [--reps N] [--rows N]

Needs CUDA. `--tree` imports `lrf_tpu_torch` from another checkout (for
example a `git archive` of the parent commit, with this checkout's kernel
builds copied into its `lrf_tpu_torch/_build/`), so that one call on one
machine times both sides of a change; run parent, change, change, parent.

On `chip_smoke.py`'s 64 bench images (512x768, its `load_images` with seed
0) at quality 10, raw factors: the encode on `cuda:0` and on
`make_mesh()` (one data row per visible card; with `--rows N`, N rows
dealt over the visible cards in turn, so several rows may share one
card), each the best of `--reps` calls after two untimed ones,
CUDA-synchronized; and, on the mesh, the
host wall time of the exact init's eigensolver summed over the rows
(`ops/svd.py::_gram_eig`, wrapped), with each call's window (start, end)
in ms from the traced encode's start on one host clock. Prints the card's name and power limit
from `nvidia-smi`, then one JSON line.

Not collected by pytest (the file name does not start with `test_`).
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = sys.argv[1:]
TREE = os.path.abspath(ARGS[ARGS.index("--tree") + 1]) if "--tree" in ARGS else ROOT
REPS = int(ARGS[ARGS.index("--reps") + 1]) if "--reps" in ARGS else 5
ROWS = int(ARGS[ARGS.index("--rows") + 1]) if "--rows" in ARGS else None
sys.path.insert(0, TREE)


def _bench_images():
    """`chip_smoke.py::load_images(0)` of this checkout, for either tree."""
    spec = importlib.util.spec_from_file_location("chip_smoke_images", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.load_images(0)


def _best_ms(torch, fn, reps: int) -> tuple[float, list]:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), times


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import lrf_tpu_torch as lt
    from lrf_tpu_torch.ops import svd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    images = _bench_images()
    count = torch.cuda.device_count()
    mesh = lt.make_mesh() if ROWS is None else lt.make_mesh(
        data=ROWS, devices=[f"cuda:{i % count}" for i in range(ROWS)])
    one_ms, one_all = _best_ms(torch, lambda: lt.sharded_qmf_encode_batch(images, quality=10, device="cuda"), REPS)
    mesh_ms, mesh_all = _best_ms(torch, lambda: lt.sharded_qmf_encode_batch(images, quality=10, device=mesh), REPS)

    eig, lock, spent = svd._gram_eig, threading.Lock(), []

    def timed(g, method):
        start = time.perf_counter()
        out = eig(g, method)
        with lock:
            spent.append((start, time.perf_counter()))
        return out

    svd._gram_eig = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lt.sharded_qmf_encode_batch(images, quality=10, device=mesh)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        svd._gram_eig = eig
    windows = sorted([(a - t0) * 1e3, (b - t0) * 1e3] for a, b in spent)
    print(json.dumps({
        "tree": TREE, "cards": count, "images": len(images), "mesh": str(mesh),
        "one_card_ms": one_ms, "one_card_all_ms": one_all, "mesh_ms": mesh_ms, "mesh_all_ms": mesh_all,
        "mesh_eigh_calls": len(windows), "mesh_eigh_ms_sum": sum(b - a for a, b in windows),
        "mesh_eigh_ms_each": [b - a for a, b in windows], "mesh_eigh_windows_ms": windows,
        "mesh_call_with_eigh_timed_ms": traced_ms,
    }), flush=True)


if __name__ == "__main__":
    main()
