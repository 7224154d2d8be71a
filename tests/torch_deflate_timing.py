"""The card's DEFLATE kernel alone at the benchmark's Kodak and CLIC shapes,
beside the host serializer's zlib-9 pool on the same factors.

    python tests/torch_deflate_timing.py [--reps N] [--seed S]

Needs CUDA. For each of `portbench/configs/kodak-q10.json` and
`clic-q10.json`: one pool batch of the benchmark's photographs (its
`images.make_pool`, seed S) encoded on `cuda:0` at q10 with raw factors
(the plain BCD sweeps, so that no BCD kernel is built);
then, on those factors, `ops/deflate.py::deflate_fibers` timed with CUDA
events (median of N after one untimed call, the card otherwise idle), the
host's `native/fibercodec.py::assemble_streams` at zlib level 9 (the
serializer's pool over every host core, median of N), and a check that
both give the same streams byte for byte. Prints the card's name and power
limit from `nvidia-smi`, then one JSON line.

Not collected by pytest (the file name does not start with `test_`).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lrf_tpu_torch.models.container import get_fiber_coder, set_fiber_coder  # noqa: E402
from lrf_tpu_torch.native import fibercodec  # noqa: E402
from lrf_tpu_torch.ops import deflate  # noqa: E402
from lrf_tpu_torch.parallel import encode as penc  # noqa: E402
from portbench import images  # noqa: E402


def cell(name: str, reps: int, seed: int) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    size, b = tuple(cfg["image_size"]), int(cfg["batch"])
    batch = images.make_pool(cfg["images"], size, b, 1, seed, "cuda")[0]
    old = get_fiber_coder()
    set_fiber_coder("deflate")  # raw factors out of the encoder
    try:
        # the plain sweeps on the card: factors like the kernel's, and no BCD build
        fn, _, spec = penc.build_sharded_encoder("cuda", size, quality=cfg["quality"], batch=b, backend="torch")
    finally:
        set_fiber_coder(*old)
    assert spec is None
    factors = [f.contiguous() for f in fn(torch.from_numpy(batch).cuda())]
    torch.cuda.synchronize()
    deflate.deflate_fibers(factors)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        slots, lens = deflate.deflate_fibers(factors)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    slots, lens = slots.cpu().numpy(), lens.cpu().numpy()
    host = [f.cpu().numpy() for f in factors]
    ms, rs = [f.shape[1] for f in host], [f.shape[2] for f in host]
    inner = penc._inner_metadata(rs)
    card = fibercodec.frame_streams(slots, lens, b, rs, deflate.slot_caps(ms), b"{}", inner)
    pool = []
    for _ in range(reps):
        t0 = time.perf_counter()
        want = fibercodec.assemble_streams(host, b, ms, rs, b"{}", inner, 9, "zlib")
        pool.append((time.perf_counter() - t0) * 1e3)
    return {
        "cell": name, "fibers": int(lens.size), "bytes_in": int(sum(f.size for f in host)),
        "bytes_out": int(lens.sum()), "kernel_ms": statistics.median(times), "kernel_ms_all": times,
        "host_pool_ms": statistics.median(pool), "launches_per_call": len(set(ms)),
        "same_streams": card == want,
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=20261018)
    args = p.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    deflate.KERNEL.lib()
    out = {"build_s": time.perf_counter() - t0, "max_fiber": deflate.KERNEL.max_fiber(),
           "cells": [cell(name, args.reps, args.seed) for name in ("kodak-q10", "clic-q10")]}
    print(json.dumps(out), flush=True)
    return 0 if all(c["same_streams"] for c in out["cells"]) else 1


if __name__ == "__main__":
    sys.exit(main())
