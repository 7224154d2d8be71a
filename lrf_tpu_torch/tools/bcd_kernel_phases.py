#!/usr/bin/env python3
"""Where the time of the cluster BCD kernel goes, on one NVIDIA GPU.

    python3 -m lrf_tpu_torch.tools.bcd_kernel_phases [--out PATH]

At the N = 64 codec shapes it runs the cluster kernel (`csrc/bcd_cluster.cu`
at the bench's ranks, `csrc/bcd_cluster_wide.cu` at the q40 Y stack) twice over:
as the port builds it, and built again with `-DLRF_BCDC_PROFILE`, in which
thread 0 of every CTA sums the clock64 cycles of each phase of the sweep
loop. It prints both builds' times (CUDA events, 10 sweeps, the factor
copies included; the difference is the timer's cost), whether the two
builds give the same bits, the mean cycles per CTA of each phase, and the
registers and spills that ptxas reports for the profiled build. Both builds
launch through `bcd_kernel._KernelLib`. Writes the numbers as JSON to `--out`
(default `results/bcd_kernel_phases.json`).

The process's first cluster-kernel launches are one launch of the port's
build per shape, in `SHAPES` order, so a profiler that reads the first
five launches of `bcd_cluster_kernel` reads exactly those:

    ncu --kernel-name regex:bcd_cluster_kernel --launch-count 5 \\
        --section SpeedOfLight --section WarpStateStats \\
        python3 -m lrf_tpu_torch.tools.bcd_kernel_phases

Needs CUDA and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

SHAPES = [(64, 6144, 64, 6), (128, 1536, 64, 3), (4, 49152, 64, 13), (1, 6144, 64, 26), (64, 6144, 64, 26)]
PHASES = ["load", "step 1", "step 2", "warp tree", "cluster barrier", "cluster sum", "V update"]
ITERS = 10
BOUNDS = (-16, 15)
REPS = 5


def ptxas_summary(log: str, ranks=(3, 6, 13, 26)) -> list[str]:
    """Registers and spills of the kernel instances at `ranks`, from `-Xptxas -v`."""
    out, current = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = next((r for r in ranks if f"bcd_cluster_kernelILi{r}E" in line), None)
        elif current is not None and ("spill" in line or "registers" in line):
            out.append(f"R={current}: {line.split(':', 1)[-1].strip()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("results", "bcd_kernel_phases.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bcd_kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    from lrf_tpu_torch.ops import bcd as bcd_mod
    from lrf_tpu_torch.ops import bcd_kernel as bk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    prof = bk._KernelLib(defines=("-DLRF_BCDC_PROFILE",))
    libs = prof.lib()
    for name in bk.CLUSTER_RANKS:
        bk._bind(libs[name], "lrf_bcdc_phase_cycles", ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong))
    bk.KERNEL.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s; profiled build: "
          + "; ".join(ptxas_summary(prof.build_log)), flush=True)
    lo, hi = bk._int_bounds(BOUNDS)

    gen = torch.Generator().manual_seed(0)
    cases = []
    for shape in SHAPES:
        b, m, n, r = shape
        x = (torch.rand((b, m, n), generator=gen) * 219 + 16).cuda()
        u0, v0, _ = bcd_mod.svd_init(x, r, bounds=BOUNDS)
        cases.append((shape, x, u0, v0))
    # The first launches: the port's build, once per shape.
    for _, x, u0, v0 in cases:
        bk.bcd(x, u0, v0, ITERS, BOUNDS)
    torch.cuda.synchronize()

    results = []
    for shape, x, u0, v0 in cases:
        u, v = torch.empty_like(u0), torch.empty_like(v0)

        def run(kernel):
            u.copy_(u0)
            v.copy_(v0)
            kernel.launch(x, u, v, ITERS, lo, hi)

        out = {}
        for kernel in (bk.KERNEL, prof):
            run(kernel)
            torch.cuda.synchronize()
            out[id(kernel)] = (u.clone(), v.clone())
        same_bits = all(torch.equal(a, c) for a, c in zip(out[id(bk.KERNEL)], out[id(prof)]))
        lib = libs[bk.KERNEL.plan(*shape[1:]).variant]
        cyc = (ctypes.c_ulonglong * (len(PHASES) + 1))()
        err = lib.lrf_bcdc_phase_cycles(cyc)  # reset
        run(prof)
        torch.cuda.synchronize()
        err = err or lib.lrf_bcdc_phase_cycles(cyc)
        if err:
            raise RuntimeError(f"phase counter copy failed: CUDA error {err}")
        ctas = max(1, cyc[len(PHASES)])
        per_cta = {p: cyc[i] / ctas for i, p in enumerate(PHASES)}
        times = {id(bk.KERNEL): [], id(prof): []}
        for kernel in (bk.KERNEL, prof, prof, bk.KERNEL):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                run(kernel)
            end.record()
            torch.cuda.synchronize()
            times[id(kernel)].append(start.elapsed_time(end) / REPS)
        ms = sum(times[id(bk.KERNEL)]) / 2
        ms_profiled = sum(times[id(prof)]) / 2
        total = sum(per_cta.values())
        print(f"{shape}: {ms:.4f} ms, profiled build {ms_profiled:.4f} ms, same bits {same_bits}; "
              f"cycles per CTA {total:.0f}: "
              + ", ".join(f"{p} {c:.0f} ({100 * c / total:.1f}%)" for p, c in per_cta.items()), flush=True)
        results.append(dict(shape=list(shape), ms=ms, ms_profiled=ms_profiled, same_bits=same_bits,
                            cycles_per_cta=per_cta, ctas=ctas, card=card))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0 if all(r["same_bits"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
