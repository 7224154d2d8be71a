"""Run one cell of `BENCHMARK.json` once, on the machine it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Exits non-zero, printing no result, when
CUDA is absent or the machine has fewer cards than the cell asks for, when
the program cannot be imported, and when `jax`, `jaxlib`, `flax` or
`lrf_tpu` is loaded once the window has closed. Otherwise the last line of
standard output is the result: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`, each number the comparison read beside its limit; the same
numbers end standard error. Build and kernel caches go to fixed
directories inside the checkout.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def report(result: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    log(f"correct: {result['correct']}")
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r}) {'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench.cells import resolve

    cell = resolve(args.workload, ROOT)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}: no result")
        return 2
    log(f"card: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from portbench.harness import forbidden_modules, run

    result = run(cell, args.seed, args.seconds, bool(args.trace), [f"cuda:{i}" for i in range(chips)], T_PROCESS, log)

    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the run may not load: {bad}: no result")
        return 3
    log(f"power.limit {result['device']['power_limit_w']} W")
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
