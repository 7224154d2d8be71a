#!/usr/bin/env python3
"""Where the time of the grid BCD kernel goes, and whom it agrees with, on one NVIDIA GPU.

    python3 -m lrf_tpu_torch.tools.bcd_grid_phases [--out PATH]

At the shapes the plan gives `csrc/bcd_grid.cu` it runs 10 sweeps on
integer X from the svd init and prints:
- the call's time (CUDA events, the factor copies included) and, from a
  `torch.profiler` trace of 3 calls, the device ms per call of each of the
  kernel's four launches per sweep (gram, u_phase, reduce, v_phase);
- the equal share of the factors against the plain version on the card
  (`bcd_reference` on CUDA tensors: cuBLAS products) and on the CPU, and
  that of `bcd.cu` (forced) where one run takes under a second, with the
  mean loss of each.
Writes the numbers as JSON to `--out` (default
`results/bcd_grid_phases.json`). Needs CUDA and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

SHAPES = [(1, 6144, 64, 48), (64, 6144, 64, 48), (1, 6144, 192, 96), (1, 512, 768, 51), (1, 256, 384, 13),
          (1, 512, 768, 256)]
ITERS = 10
BOUNDS = (-16, 15)
BCD_TIMED_MS = 1000.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("results", "bcd_grid_phases.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bcd_grid_phases: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from lrf_tpu_torch.ops import bcd as bcd_mod
    from lrf_tpu_torch.ops import bcd_kernel as bk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    bk.KERNEL.lib()
    lo, hi = bk._int_bounds(BOUNDS)

    def run(x, u0, v0, variant):
        u, v = u0.clone().contiguous(), v0.clone().contiguous()
        bk.KERNEL.launch(x, u, v, ITERS, lo, hi, variant)
        return u, v

    def call_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def agree(x, got, want):
        equal = min(float((a == b.to(a.device)).float().mean()) for a, b in zip(got, want))
        return dict(equal=equal, loss=float(bcd_mod.qmf_loss(x, *got).mean()))

    gen = torch.Generator().manual_seed(0)
    results = []
    for shape in SHAPES:
        b, m, n, r = shape
        x = torch.randint(0, 256, (b, m, n), generator=gen).to(torch.float32).cuda()
        u0, v0, _ = bcd_mod.svd_init(x, r, bounds=BOUNDS)
        grid = run(x, u0, v0, "bcd_grid")
        ms = call_ms(lambda: run(x, u0, v0, "bcd_grid"), 5 if b > 1 else 20)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run(x, u0, v0, "bcd_grid")
            torch.cuda.synchronize()
        phases = {}
        for e in prof.events():
            name = re.search(r"(gram|u_phase|reduce|v_phase)_kernel", e.name)
            if e.device_type == torch.autograd.DeviceType.CUDA and name:
                phases[name.group(1)] = phases.get(name.group(1), 0.0) + (e.time_range.end - e.time_range.start) / 3e3
        plain_card = bk.bcd_reference(x, u0, v0, num_iters=ITERS, bounds=BOUNDS)
        plain_cpu = bk.bcd_reference(x.cpu(), u0.cpu(), v0.cpu(), num_iters=ITERS, bounds=BOUNDS)
        entry = dict(shape=shape, ms=ms, phase_ms=phases, grid_vs_plain_card=agree(x, grid, plain_card),
                     grid_vs_plain_cpu=agree(x, grid, plain_cpu),
                     plain_card_vs_plain_cpu=agree(x, plain_card, plain_cpu))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        old = run(x, u0, v0, "bcd")
        end.record()
        torch.cuda.synchronize()
        if start.elapsed_time(end) < BCD_TIMED_MS:
            entry["bcd_vs_plain_card"] = agree(x, old, plain_card)
            entry["bcd_vs_grid"] = agree(x, old, grid)
        results.append(entry)
        print(f"{shape}: bcd_grid {ms:.4f} ms per call; device ms per call "
              + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
              + f"; equal share / loss against the plain version on the card "
              f"{entry['grid_vs_plain_card']['equal']:.5f} / {entry['grid_vs_plain_card']['loss']:.6f}, on the CPU "
              f"{entry['grid_vs_plain_cpu']['equal']:.5f}; plain card against CPU "
              f"{entry['plain_card_vs_plain_cpu']['equal']:.5f} (loss {entry['plain_card_vs_plain_cpu']['loss']:.6f})"
              + (f"; bcd.cu against the plain card {entry['bcd_vs_plain_card']['equal']:.5f}, against bcd_grid "
                 f"{entry['bcd_vs_grid']['equal']:.5f}" if "bcd_vs_grid" in entry else ""), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, iters=ITERS, shapes=results), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
