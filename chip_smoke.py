#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`lrf_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases 3,5,6,7,8,9,10,11,12,13]

Phases, each of which raises (exit code != 0) when a check fails:

1. card: the `nvidia-smi` name and power limit line;
2. build: compile the BCD kernels for sm_90a, one nvcc per source, all
   started together: the cluster kernel of `lrf_tpu_torch/csrc/
   bcd_cluster.cuh` (a thread-block cluster per image, X held in shared
   memory across sweeps; N = 64) at R <= 16 from `bcd_cluster.cu` and at
   17 <= R <= 32 from `bcd_cluster_wide.cu`, `lrf_tpu_torch/csrc/
   bcd_grid.cu` (one image over a grid of CTAs; N != 64 or R > 32) and
   `lrf_tpu_torch/csrc/bcd.cu` (one block per image; forced only, the
   yardstick); ptxas registers and spills per source, rank and kernel;
3. each kernel that takes a shape against the plain PyTorch version, both
   on the card: integer values inside the bounds, mean loss within 2e-3,
   more than 85% of factor entries equal, two launches bitwise equal,
   image 0 alone bitwise equal to image 0 in the batch, and the public
   `bcd` equal to the kernel its plan picks (where a kernel parts from the
   card's plain version: where they first part, how near a round() tie,
   and its share against the plain version on the CPU are printed; where
   the first parting is at a tie within 1e-4, the 85% is held against the
   plain version on the CPU instead). The shapes are the codec's
   with integer X, and the main path's own float Y and merged Cb+Cr stacks
   with their shared-eigh init; bit-equal to the plain version on integer
   X at the test shapes (a cluster kernel), and, from the init projected
   to integers, for every planned kernel wherever every sum of the sweeps,
   as `bcd_kernel.gs_sum_bound` reckons it, stays below 2^24. At the N = 64
   cluster regimes (bench Y and chroma, CLIC-size Y, the q40 Y stack alone
   and in a batch of 64) the planned cluster kernel and `bcd.cu` are timed
   in turns; at every `bcd_grid` shape (q75 and q100 Y, RGB patches, the
   no-patch codec) `bcd_grid`, `bcd.cu` (where one run takes under about a
   second) and the plain version in turns; each beside the computed bound;
4. the main path at full width: `sharded_qmf_encode_batch` of 64 RGB
   512x768 images at quality 10, then `sharded_qmf_decode_batch`; the
   R <= 16 cluster kernel must be launched exactly twice (Y, merged Cb+Cr)
   and the others not at all, the DEFLATE kernel three times (one per M:
   the card's host has no libdeflate, so "best" is zlib-9 and the encoder
   must take the card path), per-image `qmf_decode` must give the batched
   decode's pixels, and per-image PSNR must be within 0.2 dB of an encode
   whose BCD is the plain version; its encode rate is the best of three
   calls timed after two untimed ones; the init's parts beside it: the
   float64 Grams' device ms and the host's LAPACK eigh (`?syevd`, the
   exact init's eigensolver on every device, one native batch over the
   host's cores), which must equal the scipy loop's bits, against the
   scipy loop, `torch.linalg.eigh` (cuSOLVER) on the same Grams and the
   batch on one worker, with its worker count;
5. per-image round trips of the other codec variants on the card, each
   held against the same encode on the CPU at a small size; each 512x768
   encode launches `bcd_grid` once (RGB patches, RGB no-patch) or three
   times (YCbCr no-patch: Y, Cb, Cr) and no other kernel;
6. the host tail at the same width: the native fiber coder's build and
   backends; one encode with each transport (raw factors, the flat pack,
   the entropy pack), whose streams must be byte-identical, with each
   mode's encode, host and device times; the native serializer against the
   plain pure-Python one on the same fetched factors (equal bytes under
   the "zlib" coder); `deflate_fibers` on the same factors against the
   host's `assemble_streams` at zlib level 9 (equal streams; the kernel's
   device ms beside the host pool's wall ms); the synchronizing CUDA calls
   of one encode; then `sharded_qmf_encode_batches` over 8 batches, which
   must give the one-shot streams in order with 16 cluster-kernel and 24
   DEFLATE launches, and
   `sharded_qmf_decode_batches` over those streams, which must give the
   one-shot decode's pixels through the packed upload;
7. the fast init: the bench batch with `init="fast"` (two cluster-kernel
   launches, deterministic), every image's PSNR at least its exact-init
   PSNR - 0.3 dB; both inits' device ms (CUDA events) and host CPU ms, whole
   encode times, the device kernels each init launches (`torch.profiler`)
   and the synchronizing calls of a fast encode;
8. the dpack decode transport: the bench streams with `transport="dpack"`
   (the batch must take it) and `"flat"`, pixels equal to phase 4's decode;
   upload bytes, `unpack_chunks_device`'s device ms, one-shot and 8-batch
   pipelined decode rates of both, in turns;
9. meshes and processes: a data mesh over every visible card (and over
   `cuda:0` twice on a one-card machine), each row dispatched from its own
   host thread: streams equal to the one device's (or all but 2, those
   within 0.2 dB), two cluster-kernel launches per shard, its encode time
   beside one card's in the same run, and on several rows each row's init
   eigh windows on one host clock (how many overlap another row's)
   and a `torch.profiler` trace of each device's kernel span; a patch mesh of 2
   (the cards, or `cuda:0` twice) on 8 images: no kernel launch, its init
   (U, V before the sweeps) against one device's (printed), PSNR
   within 0.2 dB of the unsharded encode, no synchronizing call inside
   `sharded_bcd`'s sweep loop (`torch.cuda.set_sync_debug_mode`), its
   first and best-of-3 times and a profiler table; a two-process
   `distributed_encode` (gloo; this script re-run with `--dist-worker`,
   both processes on the card) of 16 images: streams in order, equal to
   one process's encodes of the same shards;
10. eval: `eval_compression` with `qmf_encode` / `qmf_decode` of 4 bench
   images at quality 10, 25, 40 and 75: bpp, PSNR, SSIM, encode, decode
   and encode device ms; each stack's shape and kernel (q10 and q25 launch
   only the R <= 16 cluster kernel, q40's Y stack the wide one, q75's Y
   stack `bcd_grid` and its Cb and Cr the wide one); PSNR and SSIM on the
   card equal to the CPU's within 1e-5; the planned kernel timed at every
   per-image stack, and at the q40 and q75 Y stacks the planned kernel and
   `bcd.cu` in turns, each with its share of the median encode's device
   ms; batched q40 and q75 encodes of the 64 bench images (one launch of
   each planned kernel, per-image PSNR within 0.2 dB of an encode whose BCD
   is the plain version);
   `device_benchmark` of the bench encode (five runs taken in phase 4
   right after its three timed calls, so both see the same host): its best
   within the spread of those calls (or twice its own deviation) of theirs;
11. secondary codecs and CLI, at the bench image size: the CLI in this
   process (`lrf_tpu_torch.cli.main`) encodes a 512x768 PNG at q10 with
   `bcd_cluster` launched 3 times (Y, Cb, Cr) and no other kernel, bytes
   equal to `qmf_encode`'s, decodes to `qmf_decode`'s pixels, prints JSON
   from `info` and `eval`, and does the same as `python -m lrf_tpu_torch`
   and with `--codec svd`; the SVD codec on 8 images (RGB patches and
   YCbCr, q10 and q50), HOSVD at com_ratio 50 and patch-HOSVD at bpp 0.5
   and at bpp 1 with 16x16 patches (its SSIM rank search: candidates, ms,
   and the rank or best SSIM against the CPU's) on one image, each card result
   against the CPU's: cross-decode both ways (at most 1 apart in under 0.1%
   of pixels), the same ranks, reconstructions from the float factors within
   1e-3 (relative), and with the CPU's signs PSNR within 0.1 dB (the codecs'
   truncating quantizers are not sign-free, and the solvers pick signs by
   their own rules); the card's own streams within 0.01 dB of the CPU's (SVD,
   which factors through the host's LAPACK on every device; how many streams
   are byte-identical is printed) or 0.1 dB (HOSVD; the gap with the
   quantizer's bias taken out at decode is printed); TT of a (3, 512,
   768) image, relative error within 1e-4 of the CPU's; `QMF.decompose` and
   `qmf_decompose_cuda` on one Y stack, one `bcd_cluster` launch each, and
   `QMF(verbose=True)` one per sweep, bits equal to `qmf_decompose`; `HOSVD` and
   `SVDInit`; `jacobi_eigh` on the 192 bench Grams against
   `torch.linalg.eigh` (eigenvalues, leading eigenvectors, device ms and
   device kernels of each), and Jacobi-init encodes against the default at
   q10 and q40 on 8 images; the SVD codec's card - CPU gap and encode ms
   beside their readings through `torch.linalg.svd`; the HOSVD codecs' card
   - CPU gaps and encode ms beside their readings before the mode eigh went
   to the host's LAPACK, and that eigh's ms apart;
12. the sweep layer (`lrf_tpu_torch.experiments`) at the sizes of the
   repo's photographs: the codec's Y, Cb and Cr stacks of each `local7`
   image built on the card and on the CPU, no entry apart; the comparison
   sweep over the 7 `local7` images (every 4th QMF quality of linspace(0,
   40, 80), every 3rd SVD quality of linspace(0, 5, 30), every 5th JPEG
   quality of 0-74) through
   `run_over_dataset`, first over 3 images and then resumed over all 7
   (only the other 4 swept, the first rows untouched), rows of the JAX
   package's schema, each QMF encode launching the kernels its stacks
   plan; each local7 image's exact-init Grams and init (U, V) at 3
   qualities on the card against the CPU's: Grams equal in every entry,
   inits equal or apart only by whole columns' signs at clip-penalty
   near-ties, the equal shares printed; the port on this machine's CPU
   against the card on 2 images (QMF at 3 qualities from each side's own
   init: PSNR within 0.2 dB, bpp within 1%, SSIM within 1e-3, at most 1 of
   6 streams apart, each stack that parts doing so first at round() ties;
   JPEG equal; SVD PSNR within 0.01 dB), and the same QMF points from one
   X and one init (the CPU's) on both sides: at most 1 of 6 streams apart,
   each stack that parts doing so first at round() ties (the entries apart
   within 1e-4 of x.5 in float64), the equal shares, PSNR and bpp gaps
   printed; the four
   ablations on one 768x512 image at 3 qualities (launches per config;
   num_iters 0: no launch, the init's factors; PSNR within 0.2 dB of a
   plain-BCD encode at 4x4, 16x16, 32x32 patches and no patches, whose
   stacks `bcd_grid` takes bit-equal to the plain version on integer X
   where `gs_sum_bound` < 2**24, within 2e-3 of its loss on the float
   stack, and is timed at beside the bound); `aggregate` at 0.2 and
   0.3 bpp; LOESS of each QMF curve on the card against the CPU (1e-9);
   the gap to the JAX package's stored rows (printed); `entry()`'s forward
   (3 `bcd_cluster` launches; against the plain BCD on the card and the
   CPU, and from one X and one init against the CPU: parting, if at all,
   at round() ties) and `dryrun_multichip(2)`; the comparison figures where
   this machine has matplotlib, pandas and seaborn;
13. the last two drivers (`lrf_tpu_torch.experiments`): the dataset encode
   (`distributed_encode`) of the 7 `local7` images at 512x768, q10, on
   every visible card in this process (files byte-equal to
   `sharded_qmf_encode_batch` on one card, 2 `bcd_cluster` launches per
   card and no other kernel, its Mpixel/s line, the kernel and the plain
   version timed at the batch's stacks) and as two `--multihost` gloo
   processes on the card (this script re-run with `--driver-worker`; the
   same files); the walkthrough (`qmf_pipeline.stages`) of
   `experiments/data/demo/kodim01.png` at q7 on the card (3 `bcd_cluster`
   launches) against the same machine's CPU (equal metadata, decoded pixels at
   most 1 apart in under 0.1% of pixels, PSNR within 0.01 dB) and its
   stage times.

It prints one JSON line of per-kernel numbers (for the R <= 16 cluster
kernel and `bcd.cu` summed over the two main-path shapes; for the wide
cluster kernel at the q40 Y stack, its launches counted over phase 10's q40
encodes; for `bcd_grid` at the q75 Y stack, its launches counted over phase
10's q75 encodes; for the DEFLATE kernel at the main path's factors, its
launches counted over phase 4's first encode), then as its last line
`{"ok": true, "device": {...}}`. It needs one CUDA device; without one it
exits with code 1 and prints no result. It imports neither JAX nor
`lrf_tpu`. `--phases` runs 1, 2, 4 and the phases named (for example
`--phases 9,10` on a four-card machine); such a partial run prints no
result lines. Profiler traces go to `chiprun_out/traces/`.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import glob
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BOUNDS = (-16, 15)
ITERS = 10
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 rate outside the
# tensor cores. The kernel's FMAs are f32 CUDA-core work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# (B, M, N, R): test shapes, the no-patch shape, RGB patches at quality 50
# (the regime of the TPU's streaming kernel), bench Y, bench merged chroma,
# CLIC-size Y (the regime of the TPU's per-image kernel), the q40 Y stack of
# a per-image encode and of a batch of 64, R = 32 (q50) streamed; then the
# bcd_grid regimes: the q75 and q100 Y stacks per image, q75 Y in a batch of
# 64, RGB patches at q10, RGB no-patch at q10, no-patch Cb/Cr at q10, and
# the no-patch codec at q50 (V^T V off shared memory).
KERNEL_SHAPES = [
    (3, 300, 64, 7),
    (2, 257, 64, 5),
    (1, 64, 64, 1),
    (2, 128, 64, 26),
    (2, 257, 64, 17),
    (2, 128, 64, 64),
    (1, 512, 768, 51),
    (1, 6144, 192, 96),
    (64, 6144, 64, 6),
    (128, 1536, 64, 3),
    (4, 49152, 64, 13),
    (1, 6144, 64, 26),
    (64, 6144, 64, 26),
    (1, 6144, 64, 32),
    (1, 6144, 64, 48),
    (1, 6144, 64, 64),
    (64, 6144, 64, 48),
    (1, 6144, 192, 19),
    (3, 512, 768, 51),
    (1, 256, 384, 13),
    (1, 512, 768, 256),
]
# Integer-X shapes at which a cluster kernel must equal the plain version
# bit for bit (every sum an exact integer below 2**24).
EXACT_SHAPES = [(3, 300, 64, 7), (2, 257, 64, 5), (1, 64, 64, 1), (2, 128, 64, 26), (2, 257, 64, 17)]
MAIN_SHAPES = [(64, 6144, 64, 6), (128, 1536, 64, 3)]
Q40_SHAPES = [(1, 6144, 64, 26), (64, 6144, 64, 26)]
# The N = 64 regimes where the planned cluster kernel and bcd.cu are timed in turns.
TIMED_SHAPES = MAIN_SHAPES + [(4, 49152, 64, 13)] + Q40_SHAPES
# bcd.cu is timed only where one run takes under about this many ms.
BCD_TIMED_MS = 1000.0
# What each kernel replaces (the TPU kernels' pallas_call sites).
REPLACES = "lrf_tpu/ops/bcd_pallas.py:519 (K1, K2), lrf_tpu/ops/bcd_pallas.py:722 (K3)"
# Phases that --phases can leave out; 1 (card), 2 (build) and 4 (main path) always run.
OPTIONAL_PHASES = (3, 5, 6, 7, 8, 9, 10, 11, 12, 13)


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` runs, after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def joined(torch, out):
    """`out`, after making the current stream wait for the stream it was
    made on (the card DEFLATE's side stream), so that events recorded on
    the current stream time the whole device part."""
    stream = getattr(out, "stream", None)
    if stream is not None:
        torch.cuda.current_stream().wait_stream(stream)
    return out


def deflate_bound_ms(factors, lens, rank_ints: int) -> float:
    """Least time of one `deflate_fibers` call by its bytes: the factors
    read, the streams and their lengths written, the global rank scratch
    written and read, at the card's peak bandwidth. No flop count applies:
    the work is compares and a serial parse per fiber."""
    nbytes = sum(f.nbytes for f in factors) + int(lens.sum()) + 4 * lens.size + 8 * rank_ints
    return nbytes / PEAK_BYTES_PER_S * 1e3


def ptxas_summary(log: str) -> list[str]:
    """Registers and spills that ptxas reported, one line per source: each
    cluster-kernel rank (R=...), each kernel of bcd_grid.cu, or the
    one-block kernel."""
    import re

    out, source, cur, parts = [], None, None, []
    for line in log.splitlines() + ["== end"]:
        if line.startswith("== "):
            if source and parts:
                out.append(f"{source}: " + "; ".join(parts))
            source, parts = line[3:].strip(), []
        elif "Compiling entry function" in line:
            rank = re.search(r"bcd_cluster_kernelILi(\d+)E", line)
            name = re.search(r"\d([a-z_]+_kernel)E", line)
            cur = f"R={rank.group(1)}" if rank else name.group(1) if name else "kernel"
        elif cur and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            parts.append(f"{cur} spill {spill.group(1)}/{spill.group(2)} B")
        elif cur and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            parts[-1] += f", {regs} registers"
            cur = None
    return out


def bcd_bound_ms(b: int, m: int, n: int, r: int, iters: int) -> tuple[float, str]:
    """Least time for `iters` BCD sweeps: each input read once, each output
    written once, against the f32 flops of the sweeps."""
    nbytes = 4 * b * (m * n + 2 * (m * r + n * r))
    flops = iters * b * 4 * (m * n * r + m * r * r + n * r * r)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_variant(bk, x, u0, v0, bounds, variant: str, iters: int = ITERS):
    """`iters` sweeps through one named kernel (the wrapper's internal
    variant argument), on fresh copies of the init as `bcd` makes them."""
    import torch

    u = torch.empty(u0.shape, dtype=torch.float32, device=x.device)
    v = torch.empty(v0.shape, dtype=torch.float32, device=x.device)
    u.copy_(u0)
    v.copy_(v0)
    lo, hi = bk._int_bounds(bounds)
    bk.KERNEL.launch(x, u, v, iters, lo, hi, variant)
    return u, v


def variants_for(bk, n: int, r: int) -> list[str]:
    """The kernels that take this shape: the planned one (the cluster kernel
    whose ranks hold R at N = 64, else bcd_grid), then the one-block kernel,
    which takes every shape when forced."""
    return [bk.cluster_variant(n, r) or "bcd_grid", "bcd"]


def only(bk, **want) -> dict:
    """Launch counts: `want` for the kernels named, 0 for every other."""
    return {name: want.get(name, 0) for name in bk.KERNEL.counts}


def check_contract(torch, bk, bcd_mod, label, x, u0, v0, bounds, ref, exact: bool = False) -> dict:
    """Every applicable kernel against `bcd_reference` (`ref`): integer values
    inside the bounds, mean loss within 2e-3, more than 85% of entries
    equal, or, where the two first part at a round() tie within TIE_DIST,
    more than 85% equal to the plain version on the CPU (where they part
    and how near a tie is printed), two launches bitwise
    equal, image 0 alone equal to image 0 in the
    batch; with `exact`, a cluster kernel equal to `ref` bit for bit. The
    public `bcd` must give the planned kernel's result."""
    b, m, n = x.shape
    r = u0.shape[-1]
    ur, vr = ref
    loss_r = float(bcd_mod.qmf_loss(x, ur, vr).mean())
    lo, hi = bounds
    out, cpu_ref = {}, []
    for variant in variants_for(bk, n, r):
        uk, vk = run_variant(bk, x, u0, v0, bounds, variant)
        uk2, vk2 = run_variant(bk, x, u0, v0, bounds, variant)
        u1, v1 = run_variant(bk, x[:1].contiguous(), u0[:1], v0[:1], bounds, variant)
        torch.cuda.synchronize()
        for f in (uk, vk):
            check(bool(torch.all(f == torch.round(f))), f"{label} {variant}: non-integer factor")
            check(float(f.min()) >= lo and float(f.max()) <= hi, f"{label} {variant}: factor outside {bounds}")
        loss_k = float(bcd_mod.qmf_loss(x, uk, vk).mean())
        eq_u = float((uk == ur).float().mean())
        eq_v = float((vk == vr).float().mean())
        err = max(float((uk - ur).abs().max()), float((vk - vr).abs().max()))
        check(abs(loss_k - loss_r) < 2e-3, f"{label} {variant}: loss {loss_k} vs plain {loss_r}")
        at, eq_cpu = None, None
        if not (torch.equal(uk, ur) and torch.equal(vk, vr)):
            # where the kernel parts from the card's plain version: where they
            # first part, and the kernel's share against the plain version on
            # the CPU (which side parted)
            at = parting(torch, x.cpu().double(), (u0, v0),
                         lambda k: [t.cpu() for t in run_variant(bk, x, u0, v0, bounds, variant, k)],
                         lambda k: [t.cpu() for t in bk.bcd_reference(x, u0, v0, num_iters=k, bounds=bounds)])
            if not cpu_ref:
                cpu_ref.extend(bk.bcd_reference(x.cpu(), u0.cpu(), v0.cpu(), num_iters=ITERS, bounds=bounds))
            uc, vc = cpu_ref
            eq_cpu = (float((uk.cpu() == uc).float().mean()), float((vk.cpu() == vc).float().mean()))
            print(f"kernel {variant} {label}: parts from the plain version on the card "
                  + (f"at sweep {at[0]}, {at[1]} pass, {at[2]} entries of its first column apart, each within "
                     f"{at[3]:.3g} of a rounding tie" if at else "nowhere in a rerun")
                  + f"; against the plain version on the CPU equal U {eq_cpu[0]:.5f} V {eq_cpu[1]:.5f}; the card's "
                  f"plain version against the CPU's U {float((ur.cpu() == uc).float().mean()):.5f} "
                  f"V {float((vr.cpu() == vc).float().mean()):.5f}", flush=True)
        # More than 85% of entries equal to the card's plain version; where
        # the two first part at a round() tie of the sweeps, which float32
        # sum orders decide each their own way, more than 85% equal to the
        # plain version on the CPU instead. The exact init met such a tie at
        # (1, 6144, 192, 19): one U entry of sweep 1 at 1.73e-07 from x.5,
        # the kernel and the CPU's plain version on one side (100% equal),
        # the card's cuBLAS plain version on the other (92.56% / 82.29%),
        # every other shape 100% (H100, 700 W).
        shares = eq_cpu if at is not None and at[3] < TIE_DIST else (eq_u, eq_v)
        check(shares[0] > 0.85 and shares[1] > 0.85,
              f"{label} {variant}: equal share U {eq_u} V {eq_v} (against the CPU's plain version {eq_cpu}), "
              f"first parting {at}")
        check(torch.equal(uk, uk2) and torch.equal(vk, vk2), f"{label} {variant}: two launches differ")
        check(torch.equal(uk[:1], u1) and torch.equal(vk[:1], v1), f"{label} {variant}: image 0 depends on the batch")
        if exact and variant != "bcd":
            check(torch.equal(uk, ur) and torch.equal(vk, vr), f"{label} {variant}: not bit-equal on integer X")
        plan = bk.KERNEL.plan(m, n, r, variant)
        if variant == "bcd":
            where = f"{plan.tile}-row tiles, {'shared' if plan.state_in_smem else 'global'} state"
        elif variant == "bcd_grid":
            where = (f"{plan.cluster} CTAs of {plan.tile} rows per image, V^T V in "
                     f"{'shared memory' if plan.state_in_smem else 'the scratch'}, "
                     f"{4 * b * plan.scratch_floats} B of scratch")
        else:
            where = (f"cluster {plan.cluster} x {plan.rows_per_cta} rows, "
                     f"{'resident' if plan.resident else f'streamed in {plan.tile}-row tiles'}")
        print(f"kernel {variant} {label}: ok, loss {loss_k:.6f} vs plain {loss_r:.6f}, equal U {eq_u:.5f} "
              f"V {eq_v:.5f}, max|diff| {err:g}; {where}, {plan.smem_bytes} B smem", flush=True)
        out[variant] = dict(uk=uk, vk=vk, err=err, eq=min(eq_u, eq_v))
    planned = bk.KERNEL.plan(m, n, r).variant
    before = dict(bk.KERNEL.counts)
    ub, vb = bk.bcd(x, u0, v0, num_iters=ITERS, bounds=bounds)
    torch.cuda.synchronize()
    check(bk.KERNEL.counts[planned] == before[planned] + 1, f"{label}: bcd did not launch {planned}")
    check(torch.equal(ub, out[planned]["uk"]) and torch.equal(vb, out[planned]["vk"]),
          f"{label}: bcd differs from its planned kernel {planned}")
    return {k: dict(err=d["err"], eq=d["eq"]) for k, d in out.items()}


def time_pair(bk, x, u0, v0, reps_new: int, reps_old: int) -> dict:
    """The planned kernel and bcd.cu in turns (new, old, old, new)."""
    b, m, n = x.shape
    new = bk.KERNEL.plan(m, n, u0.shape[-1]).variant
    t = {new: [], "bcd": []}
    for variant in (new, "bcd", "bcd", new):
        reps = reps_new if variant == new else reps_old
        t[variant].append(cuda_ms(lambda: run_variant(bk, x, u0, v0, BOUNDS, variant), reps))
    return {k: sum(v) / len(v) for k, v in t.items()}


def check_integer_init(torch, bk, label, x, u0, v0, bounds) -> None:
    """From the init projected to integers, every sum of the sweeps on
    integer X is an exact integer while its magnitude stays below 2**24, as
    `bk.gs_sum_bound` reckons it along the plain path: there the planned
    kernel must equal the plain version bit for bit, whatever its order."""
    b, m, n = x.shape
    r = u0.shape[-1]
    lo, hi = bk._int_bounds(bounds)
    ui, vi = torch.clamp(torch.round(u0), lo, hi), torch.clamp(torch.round(v0), lo, hi)
    sums = bk.gs_sum_bound(x, ui, vi, ITERS, bounds)
    planned = bk.KERNEL.plan(m, n, r).variant
    if sums < bk.EXACT_LIMIT:
        uk, vk = run_variant(bk, x, ui, vi, bounds, planned)
        ur, vr = bk.bcd_reference(x, ui, vi, num_iters=ITERS, bounds=bounds)
        check(torch.equal(uk, ur) and torch.equal(vk, vr), f"{label} {planned}: not bit-equal from the integer init")
    print(f"kernel {planned} {label}: from the integer init the reckoned sums reach {sums:g}: "
          f"{'below 2**24, bit-equal to the plain version' if sums < bk.EXACT_LIMIT else 'not below 2**24'}",
          flush=True)


def time_grid(bk, x, u0, v0, reps: int) -> dict:
    """bcd_grid, bcd.cu and the plain version in turns (grid, bcd, plain,
    plain, bcd, grid); bcd.cu only where one run takes under BCD_TIMED_MS,
    else its one run is the reading."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run_variant(bk, x, u0, v0, BOUNDS, "bcd")
    end.record()
    torch.cuda.synchronize()
    once = start.elapsed_time(end)
    fns = {
        "bcd_grid": (lambda: run_variant(bk, x, u0, v0, BOUNDS, "bcd_grid"), reps),
        "bcd": (lambda: run_variant(bk, x, u0, v0, BOUNDS, "bcd"), 1 if once > 100 else 5),
        "plain": (lambda: bk.bcd_reference(x, u0, v0, num_iters=ITERS), 1),
    }
    t = {k: [] for k in fns}
    for name in ("bcd_grid", "bcd", "plain", "plain", "bcd", "bcd_grid"):
        if name == "bcd" and once >= BCD_TIMED_MS:
            continue
        fn, n = fns[name]
        t[name].append(cuda_ms(fn, n))
    out = {k: sum(v) / len(v) for k, v in t.items() if v}
    if once >= BCD_TIMED_MS:
        out["bcd"] = once
    return out


def phase_kernel(torch, bk, bcd_mod, seed: int, real_stacks):
    """Phase 3: every kernel that takes a shape against `bcd_reference` on
    the card, at the codec's shapes with integer X and at the main path's
    own float stacks; the same-run timing of the planned cluster kernel and
    bcd.cu at the N = 64 regimes of TIMED_SHAPES, and of bcd_grid, bcd.cu and
    the plain version at every shape the plan gives bcd_grid."""
    gen = torch.Generator().manual_seed(seed)
    per_shape = {}
    for shape in KERNEL_SHAPES:
        b, m, n, r = shape
        x = torch.randint(0, 256, (b, m, n), generator=gen).to(torch.float32).cuda()
        bound_sets = [BOUNDS] + ([(-8, 7)] if shape == KERNEL_SHAPES[0] else [])
        for bounds in bound_sets:
            u0, v0, _ = bcd_mod.svd_init(x, r, bounds=bounds)
            launches = bk.KERNEL.launches
            uz, vz = bk.bcd(x, u0, v0, num_iters=0, bounds=bounds)
            check(bk.KERNEL.launches == launches, f"{shape}: num_iters=0 launched a kernel")
            check(torch.equal(uz, u0) and torch.equal(vz, v0), f"{shape}: num_iters=0 changed the init")
            ref = bk.bcd_reference(x, u0, v0, num_iters=ITERS, bounds=bounds)
            label = f"{shape}" + ("" if bounds == BOUNDS else f" bounds {bounds}")
            res = check_contract(torch, bk, bcd_mod, label, x, u0, v0, bounds, ref, exact=shape in EXACT_SHAPES)
            check_integer_init(torch, bk, label, x, u0, v0, bounds)
            if bounds != BOUNDS:
                continue
            entry = dict(err={k: d["err"] for k, d in res.items()}, ms={})
            big = b * m * n > 10_000_000
            if bk.KERNEL.plan(m, n, r).variant == "bcd_grid":
                entry["ms"] = time_grid(bk, x, u0, v0, 5 if big else 20)
                entry["plain_ms"] = entry["ms"].pop("plain")
            else:
                if shape in TIMED_SHAPES:
                    entry["ms"] = time_pair(bk, x, u0, v0, 10 if big else 20, 3 if big else 10)
                else:
                    entry["ms"] = {variants_for(bk, n, r)[0]: cuda_ms(lambda: bk.bcd(x, u0, v0, num_iters=ITERS),
                                                                     3 if big else 10)}
                entry["plain_ms"] = cuda_ms(lambda: bk.bcd_reference(x, u0, v0, num_iters=ITERS), 2 if big else 3)
            entry["bound_ms"], entry["bound_by"] = bcd_bound_ms(b, m, n, r, ITERS)
            per_shape[shape] = entry
            times = ", ".join(f"{k} {v:.4f} ms ({100 * entry['bound_ms'] / v:.1f}% of bound)"
                              for k, v in entry["ms"].items())
            print(f"time {shape}: {times}; plain {entry['plain_ms']:.4f} ms; bound {entry['bound_ms']:.6g} ms "
                  f"({entry['bound_by']})", flush=True)
        plan = bk.KERNEL.plan(m, n, r)
        if shape in TIMED_SHAPES:
            print(f"plan {shape}: {plan}; {bk.KERNEL.max_active_clusters(plan, r)} clusters at once", flush=True)
        elif plan.variant == "bcd_grid":
            print(f"plan {shape}: {plan}", flush=True)
    # The main path's own stacks: the float YCbCr planes and their shared-eigh init.
    for label, x, u0, v0 in real_stacks:
        ref = bk.bcd_reference(x, u0, v0, num_iters=ITERS, bounds=BOUNDS)
        res = check_contract(torch, bk, bcd_mod, label, x, u0, v0, BOUNDS, ref)
        per_shape[label] = dict(err={k: d["err"] for k, d in res.items()})
    return per_shape


def main_path_stacks(torch, lt, bcd_mod, seed: int):
    """The Y and merged Cb+Cr stacks of the main path at 64 x 512x768, q10,
    with their `svd_init_shared` init, as `build_sharded_encoder` makes them."""
    return batch_stacks(torch, lt, bcd_mod, load_images(seed))


def batch_stacks(torch, lt, bcd_mod, images: np.ndarray):
    """The Y and merged Cb+Cr stacks of a q10 batched encode of `images`,
    with their `svd_init_shared` init, as `build_sharded_encoder` makes them."""
    from lrf_tpu_torch.ops import color, pad, patch, resample

    _, metadata, _ = lt.build_sharded_encoder("cuda", images.shape[-2:], quality=10)
    x_dev = torch.from_numpy(images).cuda()
    chans = resample.chroma_downsample(color.rgb_to_ycbcr(x_dev), (0.5, 0.5))
    stacks = [patch.patchify(pad.pad_image(c, (8, 8)), (8, 8)) for c in chans]
    merged = torch.cat(stacks[1:], dim=0)
    ranks = metadata["rank"]
    (uy, vy, _), (uc, vc, _) = bcd_mod.svd_init_shared([stacks[0], merged], ranks[:2], bounds=BOUNDS)
    y = stacks[0].contiguous()
    c = merged.contiguous()
    return [(f"real Y {tuple(y.shape)} R={ranks[0]}", y, uy, vy),
            (f"real Cb+Cr {tuple(c.shape)} R={ranks[1]}", c, uc, vc)]


def load_images(seed: int, count: int = 64, size=(512, 768)) -> np.ndarray:
    """`count` RGB `size` images: center crops, flips and rolls of the repo's
    PNGs (reflect-padded where smaller), plus seeded Gaussian noise."""
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(HERE, "experiments/data/demo/*.png")))
    paths += sorted(glob.glob(os.path.join(HERE, "experiments/data/local7/*.png")))
    check(len(paths) > 0, "no PNGs under experiments/data")
    h, w = size
    sources = []
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB")).transpose(2, 0, 1)
        ph, pw = max(0, h - img.shape[1]), max(0, w - img.shape[2])
        img = np.pad(img, ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)), mode="reflect")
        sources.append(img)
    rng = np.random.default_rng(seed)
    out = np.empty((count, 3, h, w), np.uint8)
    for i in range(count):
        src = sources[i % len(sources)]
        k = i // len(sources)
        src = np.roll(src, (17 * k, 29 * k), axis=(1, 2))
        top, left = (src.shape[1] - h) // 2, (src.shape[2] - w) // 2
        img = src[:, top : top + h, left : left + w]
        if k & 1:
            img = img[:, :, ::-1]
        if k & 2:
            img = img[:, ::-1, :]
        noisy = img.astype(np.float32) + rng.normal(0.0, 2.0, img.shape).astype(np.float32)
        out[i] = np.clip(np.rint(noisy), 0, 255).astype(np.uint8)
    return out


def per_image_psnr(ref: np.ndarray, dec: np.ndarray) -> np.ndarray:
    err = ((ref.astype(np.float64) - dec.astype(np.float64)) ** 2).mean(axis=(-3, -2, -1))
    return 20 * np.log10(255.0 / np.sqrt(err))


def phase_main_path(torch, lt, bk, seed: int, label: str):
    """Phase 4: batched encode and decode at 64 x 3 x 512 x 768, quality 10."""
    from lrf_tpu_torch.ops import deflate

    images = load_images(seed)
    b, _, h, w = images.shape
    mpix = b * h * w / 1e6

    spec = lt.build_sharded_encoder("cuda", (h, w), quality=10, batch=b)[2]
    check(spec is not None and spec["mode"] == "zlib9",
          f"the main path's encoder does not DEFLATE on the card (pack spec {spec and spec['mode']}; coder "
          f"{lt.get_fiber_coder()})")
    for name in bk.KERNEL.counts:
        bk.KERNEL.counts[name] = 0
    deflate.KERNEL.counts["deflate"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = lt.sharded_qmf_encode_batch(images, quality=10, device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(bk.KERNEL.counts)
    check(launches == only(bk, bcd_cluster=2),
          f"main path launched the kernels {launches} times, expected bcd_cluster twice (Y, Cb+Cr)")
    deflate_launches = deflate.KERNEL.counts["deflate"]
    check(deflate_launches == 3, f"main path launched the DEFLATE kernel {deflate_launches} times, expected 3 "
          f"(one per M: 6144, 1536, 64)")
    print(f"main path: kernel launches {launches}, DEFLATE {deflate_launches}, in one encode of {b} images "
          f"(first encode {first_s:.3f} s)")

    # Two untimed encodes first: the timed ones read up to 27 ms (11%) slower
    # right after the first encode than a few seconds later (PERF.md section 7).
    for _ in range(2):
        lt.sharded_qmf_encode_batch(images, quality=10, device="cuda")
    enc_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = lt.sharded_qmf_encode_batch(images, quality=10, device="cuda")
        enc_s.append(time.perf_counter() - t0)
    check(again == streams, "batched encode is not deterministic")
    # device_benchmark of the same encode right after the three calls, so
    # both see the same host; phase 10 holds the two against each other
    bench = lt.device_benchmark(lambda: lt.sharded_qmf_encode_batch(images, "cuda", 10), warmup=0, repeats=5,
                                pixels=b * h * w)

    fn, metadata, _ = lt.build_sharded_encoder("cuda", (h, w), quality=10)
    x_dev = torch.from_numpy(images).cuda()
    device_ms = cuda_ms(lambda: fn(x_dev), 3)
    # The front end and the init (Gram, one batched eigh, sign choice) alone.
    from lrf_tpu_torch.ops import bcd as bcd_mod
    from lrf_tpu_torch.ops import color, pad, patch, resample

    def front_end():
        chans = resample.chroma_downsample(color.rgb_to_ycbcr(x_dev), (0.5, 0.5))
        return [patch.patchify(pad.pad_image(c, (8, 8)), (8, 8)) for c in chans]

    front_ms = cuda_ms(front_end, 3)
    stacks = front_end()
    merged = torch.cat(stacks[1:], dim=0)
    ranks = metadata["rank"]
    init_ms = cuda_ms(lambda: bcd_mod.svd_init_shared([stacks[0], merged], ranks[:2], bounds=BOUNDS), 3)
    # The init's parts: the float64 Grams on the card, then the host's LAPACK
    # eigh of them (the Grams to the host and back included): the native
    # batch over the host's cores, against the scipy loop, cuSOLVER's
    # `torch.linalg.eigh` of the same Grams and the batch on one worker,
    # best of 3 each. The batch must give the scipy loop's bits.
    from lrf_tpu_torch.native import lapack_batch
    from lrf_tpu_torch.ops import svd

    gram_ms = cuda_ms(lambda: [svd.exact_gram(x) for x in (stacks[0], merged)], 3)
    grams = torch.cat([svd.exact_gram(x) for x in (stacks[0], merged)])
    eigh_s, native = best_s(lambda: svd._lapack_eigh(grams))
    plain_s, plain = best_s(lambda: svd._lapack_eigh_plain(grams))
    def one_worker_eigh():
        with svd._host_lapack(True):
            w, v = lapack_batch.syevd_batch(grams.cpu().numpy(), 1)
        return torch.from_numpy(w).cuda(), torch.from_numpy(v).cuda()

    one_worker_s, one_worker = best_s(one_worker_eigh)
    cusolver_s, _ = best_s(lambda: torch.linalg.eigh(grams))
    for what, got in (("the native batch", native), ("the native batch on one worker", one_worker)):
        check(all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, plain)),
              f"{what} parts from the scipy loop's ?syevd bits on the {len(grams)} bench Grams")
    workers = min(len(grams), lapack_batch.instances())
    # host CPU of the eigh, and of this process in the 200 ms after it (a
    # BLAS whose threads spin after a call takes the serializer's cores)
    c0 = time.process_time()
    svd._lapack_eigh(grams)
    c1 = time.process_time()
    time.sleep(0.2)
    eigh_cpu_ms, after_cpu_ms = (c1 - c0) * 1e3, (time.process_time() - c1) * 1e3

    dec = lt.sharded_qmf_decode_batch(streams, device="cuda")
    dec_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec2 = lt.sharded_qmf_decode_batch(streams, device="cuda")
        dec_s.append(time.perf_counter() - t0)
    check(dec.shape == images.shape and dec.dtype == np.uint8, f"decoded {dec.shape} {dec.dtype}")
    check(np.array_equal(dec, dec2), "batched decode is not deterministic")
    for i, s in enumerate(streams):
        check(np.array_equal(lt.qmf_decode(s, device="cuda"), dec[i]), f"image {i}: per-image decode differs")

    plain_streams = lt.sharded_qmf_encode_batch(images, quality=10, device="cuda", backend="torch")
    plain_dec = lt.sharded_qmf_decode_batch(plain_streams, device="cuda")
    p_kernel = per_image_psnr(images, dec)
    p_plain = per_image_psnr(images, plain_dec)
    check(bool(np.all(np.isfinite(p_kernel))) and float(p_kernel.min()) > 15.0, f"PSNR {p_kernel.min()}")
    worst = float(np.abs(p_kernel - p_plain).max())
    check(worst < 0.2, f"PSNR differs from the plain-BCD encode by {worst} dB")
    same = sum(a == c for a, c in zip(streams, plain_streams))
    enc_best, dec_best = min(enc_s), min(dec_s)
    print(f"main path: PSNR mean {p_kernel.mean():.4f} dB (min {p_kernel.min():.4f}); plain-BCD encode "
          f"max |dPSNR| {worst:.6f} dB, {same}/{b} streams byte-identical")
    print(f"main path [{label}]: encode {mpix / enc_best:.3f} Mpix/s ({enc_best * 1e3:.2f} ms per batch, "
          f"device part {device_ms:.3f} ms); decode {mpix / dec_best:.3f} Mpix/s ({dec_best * 1e3:.2f} ms)")
    print(f"main path [{label}]: of the {device_ms:.3f} ms device part, front end (color, chroma "
          f"downsample, pad, patchify) {front_ms:.3f} ms, init (Grams + eigh of {b + 2 * b} 64x64 matrices + "
          f"signs) {init_ms:.3f} ms; host part (fetch + native serializer) {enc_best * 1e3 - device_ms:.2f} ms")
    print(f"main path [{label}]: the init's float64 Grams {gram_ms:.3f} device ms; its eigh on the host's LAPACK "
          f"(?syevd as one native batch on {workers} workers, each on its own OpenBLAS instance; copies included) {eigh_s * 1e3:.3f} ms wall, equal bit "
          f"for bit to the scipy loop's {plain_s * 1e3:.3f} ms wall; the batch on one worker {one_worker_s * 1e3:.3f} "
          f"ms wall; torch.linalg.eigh (cuSOLVER) of the same {len(grams)} Grams {cusolver_s * 1e3:.3f} ms wall; "
          f"whole encode {enc_best * 1e3:.2f} ms; the eigh's host CPU {eigh_cpu_ms:.1f} ms, and {after_cpu_ms:.1f} "
          f"ms in the 200 ms after it", flush=True)
    return dict(launches=launches, deflate_launches=deflate_launches, enc_ms=enc_best * 1e3, enc_all_ms=[t * 1e3 for t in enc_s], bench=bench,
                device_ms=device_ms, streams=streams, dec=dec, gram_ms=gram_ms, eigh_ms=eigh_s * 1e3,
                cusolver_ms=cusolver_s * 1e3)


def phase_variants(torch, lt, bk, seed: int):
    """Phase 5: per-image round trips of the other variants on the card;
    each 512x768 encode launches bcd_grid once per BCD call (RGB patches
    (1, 6144, 192, 19); YCbCr no-patch Y (1, 512, 768, 51), Cb and Cr
    (1, 256, 384, 13); RGB no-patch (3, 512, 768, 51)) and no other kernel."""
    img = load_images(seed + 1, count=1)[0]
    small = np.ascontiguousarray(img[:, 100:164, 200:296])
    for kwargs, grid_launches in (
        (dict(color_space="RGB", patch=True), 1),
        (dict(color_space="YCbCr", patch=False), 3),
        (dict(color_space="RGB", patch=False), 1),
    ):
        for name in bk.KERNEL.counts:
            bk.KERNEL.counts[name] = 0
        stream = lt.qmf_encode(img, quality=10, device="cuda", **kwargs)
        launches = dict(bk.KERNEL.counts)
        check(launches == only(bk, bcd_grid=grid_launches),
              f"{kwargs}: launched {launches}, expected bcd_grid {grid_launches} time(s)")
        dec = lt.qmf_decode(stream, device="cuda")
        check(dec.shape == img.shape and dec.dtype == np.uint8, f"{kwargs}: decoded {dec.shape}")
        p = float(per_image_psnr(img, dec))
        gpu = lt.qmf_decode(lt.qmf_encode(small, quality=10, device="cuda", **kwargs), device="cuda")
        cpu = lt.qmf_decode(lt.qmf_encode(small, quality=10, device="cpu", **kwargs), device="cpu")
        dp = abs(float(per_image_psnr(small, gpu)) - float(per_image_psnr(small, cpu)))
        check(np.isfinite(p) and p > 10.0, f"{kwargs}: PSNR {p}")
        check(dp < 0.2, f"{kwargs}: card vs CPU on a 64x96 crop differ by {dp} dB")
        print(f"variant {kwargs}: ok, 512x768 PSNR {p:.4f} dB, launches {launches}; 64x96 card vs CPU |dPSNR| "
              f"{dp:.6f} dB", flush=True)


def best_s(fn, reps: int = 3):
    """(best host-clock seconds of `reps` runs, the last result); each run
    starts and ends with the device idle."""
    import torch

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times), out


def sync_sites(torch, fn) -> list[str]:
    """The synchronizing CUDA calls that `fn()` makes, by call site, from
    `torch.cuda.set_sync_debug_mode("warn")`."""
    import collections
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, HERE)}:{w.lineno} ({str(w.message).splitlines()[0][:60]})"
        for w in caught if "called a synchronizing" in str(w.message)
    )
    return [f"{n} x {site}" for site, n in sites.items()]


def phase_host_tail(torch, lt, bk, seed: int, label: str) -> None:
    """Phase 6: the transports, the native serializer against the plain one,
    and the pipelined encode and decode over 8 batches."""
    from lrf_tpu_torch.native import fibercodec as native
    from lrf_tpu_torch.ops import deflate, entropy
    from lrf_tpu_torch.parallel import decode as pdec
    from lrf_tpu_torch.parallel import encode as penc

    images = load_images(seed)
    b, _, h, w = images.shape
    mpix = b * h * w / 1e6
    x_dev = torch.from_numpy(images).cuda()
    coder = lt.get_fiber_coder()
    print(f"host tail [{label}]: fiber coder {coder}, native backends {native.backends()}, "
          f"{os.cpu_count()} host cores")

    runs = {}
    for mode in (None, "flat", "entropy"):
        fn, metadata, spec = lt.build_sharded_encoder("cuda", (h, w), quality=10, batch=b, pack=mode)
        if mode is None:
            check(spec is not None and spec["mode"] == "zlib9", f"raw factors do not DEFLATE on the card: {spec}")
        device_ms = cuda_ms(lambda: joined(torch, fn(x_dev)), 3)
        deflate.KERNEL.counts["deflate"] = 0
        streams = lt.sharded_qmf_encode_batch(images, quality=10, device="cuda", pack=mode)
        want = 3 if mode is None else 0
        check(deflate.KERNEL.counts["deflate"] == want,
              f"pack={mode}: one encode launched the DEFLATE kernel {deflate.KERNEL.counts['deflate']} times, "
              f"expected {want}")
        enc_s, again = best_s(lambda: lt.sharded_qmf_encode_batch(images, quality=10, device="cuda", pack=mode))
        check(again == streams, f"pack={mode}: encode is not deterministic")
        out = fn(x_dev)
        d2h = sum(t.numel() * t.element_size() for t in out)
        fetch_s, host_out = best_s(lambda: penc._fetch_encoded(penc._start_fetch(out), spec), 1)
        ser_s, again = best_s(lambda: penc._serialize_batch(host_out, spec, metadata, b))
        check(again == streams, f"pack={mode}: serializing the fetched buffers gives other streams")
        runs[mode] = dict(streams=streams, host_out=host_out, spec=spec, metadata=metadata)
        extra = ""
        if mode == "entropy":
            seg_base = host_out[0]
            n_values = sum(int(np.prod(s)) for s in spec["shapes"])
            used_words = spec["n_seg_words"] + spec["main_words"] + int(seg_base[-1]) * entropy.ROW_WORDS
            extra = (f"; {int(seg_base[-1])} of {spec['exc_budget']} continuation rows used, "
                     f"{32 * used_words / n_values:.4f} bits/value used ({32 * d2h / 4 / n_values:.4f} fetched; "
                     f"table's own {entropy.expected_bits_per_value():.4f}); ENTROPY_STATS {penc.ENTROPY_STATS}")
        print(f"host tail [{label}] pack={mode}: encode {enc_s * 1e3:.2f} ms ({mpix / enc_s:.3f} Mpix/s); "
              f"device part {device_ms:.3f} ms (CUDA events{', the side stream joined' if mode is None else ''}); fetch {fetch_s * 1e3:.3f} ms of {d2h} B; "
              f"host part (native serializer, best of 3) {ser_s * 1e3:.3f} ms{extra}", flush=True)
    raw = runs[None]["streams"]
    for mode in ("flat", "entropy"):
        check(runs[mode]["streams"] == raw, f"pack={mode} streams differ from the raw-factor streams")
    flat = runs["flat"]["spec"]  # raw factors (pack None may DEFLATE on the card)
    factors = penc._unpack_factors(runs["flat"]["host_out"], flat["shapes"], flat["dtype"], flat["lo"], flat["bits"])
    decoded = penc._decode_entropy(runs["entropy"]["host_out"], runs["entropy"]["spec"])
    check(all(np.array_equal(a, c) for a, c in zip(factors, decoded)), "entropy transport changed a factor value")
    print(f"host tail [{label}]: raw, flat and entropy transports give byte-identical streams ({b} of {b})")
    dev_factors = [torch.from_numpy(f).cuda() for f in factors]
    flat_ms = cuda_ms(lambda: penc._pack_factors(dev_factors, -16, 5), 10)
    budget = runs["entropy"]["spec"]["exc_budget"]
    entropy_ms = cuda_ms(lambda: entropy.pack_segments(dev_factors, max_exc_rows=budget), 10)
    print(f"host tail [{label}]: transport packs alone on the main path's factors (CUDA events, mean of 10): "
          f"flat {flat_ms:.3f} ms, entropy {entropy_ms:.3f} ms")

    # The DEFLATE kernel on the same factors against the host's zlib-9 pool
    ms, rs = [f.shape[1] for f in factors], [f.shape[2] for f in factors]
    inner = penc._inner_metadata(rs)
    slots, lens = deflate.deflate_fibers(dev_factors)
    card = native.frame_streams(slots.cpu().numpy(), lens.cpu().numpy(), b, rs, deflate.slot_caps(ms), b"{}", inner)
    pool_s, host = best_s(lambda: native.assemble_streams(factors, b, ms, rs, b"{}", inner, 9, "zlib"))
    check(card == host, "deflate_fibers' streams differ from the host's zlib level 9")
    check(card == native.frame_streams(*runs[None]["host_out"], b, rs, deflate.slot_caps(ms), b"{}", inner),
          "the encoder's card streams differ from deflate_fibers' on the same factors")
    deflate_ms = cuda_ms(lambda: deflate.deflate_fibers(dev_factors), 10)
    lib, global_rank, rank_ints = deflate.KERNEL.lib(), ctypes.c_int(0), 0
    for f in factors:
        check(lib.lrf_deflate_global_rank(f.shape[1], ctypes.byref(global_rank)) == 0, "shared memory query")
        rank_ints += f.size if global_rank.value else 0
    lens_np = lens.cpu().numpy()
    bound_ms = deflate_bound_ms(factors, lens_np, rank_ints)
    print(f"host tail [{label}]: deflate_fibers on the main path's factors ({sum(f.size for f in factors)} B in, "
          f"{int(lens_np.sum())} B of streams): {deflate_ms:.3f} ms (CUDA events, mean of 10), bound by bytes "
          f"{bound_ms:.6f} ms; host zlib-9 pool (assemble_streams, {os.cpu_count()} cores, best of 3) "
          f"{pool_s * 1e3:.3f} ms; streams byte-identical", flush=True)
    deflate_run = dict(ms=deflate_ms, plain_ms=pool_s * 1e3, bound_ms=bound_ms,
                       shapes=[list(f.shape) for f in factors])

    metadata = runs[None]["metadata"]
    lt.set_fiber_coder("zlib")
    try:
        native_s, native_zlib = best_s(lambda: penc._serialize_batch(factors, None, metadata, b))
    finally:
        lt.set_fiber_coder(*coder)
    plain_s, plain = best_s(lambda: penc._serialize_plain(factors, metadata, b))
    check(native_zlib == plain, "native serializer under 'zlib' differs from the pure-Python one")
    print(f"host tail [{label}]: host part on the same fetched factors: native serializer ('zlib') "
          f"{native_s * 1e3:.3f} ms, pure-Python serializer {plain_s * 1e3:.3f} ms "
          f"({plain_s / native_s:.2f}x), bytes identical; default coder {coder} streams "
          f"{'equal' if raw == native_zlib else 'differ from'} the zlib streams")
    for line in sync_sites(torch, lambda: lt.sharded_qmf_encode_batch(images, quality=10, device="cuda")):
        print(f"host tail: sync in one raw encode: {line}")
    # How much of the init's eigh is host work: CPU seconds of this process
    # against wall seconds for the main path's 3B Grams of 64 x 64.
    grams = torch.randn(3 * b, 64, 64, generator=torch.Generator().manual_seed(seed)).cuda()
    grams = grams @ grams.transpose(-1, -2)
    torch.linalg.eigh(grams)
    torch.cuda.synchronize()
    cpu0, wall0 = time.process_time(), time.perf_counter()
    torch.linalg.eigh(grams)
    torch.cuda.synchronize()
    print(f"host tail [{label}]: torch.linalg.eigh of {3 * b} 64x64 Grams: {(time.perf_counter() - wall0) * 1e3:.3f} ms "
          f"wall, {(time.process_time() - cpu0) * 1e3:.3f} ms of host CPU time")

    batches = [images] + [load_images(seed + k) for k in range(1, 8)]
    n = len(batches)
    one_s, one_shot = best_s(lambda: [lt.sharded_qmf_encode_batch(x, quality=10, device="cuda") for x in batches], 1)
    half_s, _ = best_s(lambda: list(lt.sharded_qmf_encode_batches(batches[: n // 2], quality=10, device="cuda")), 1)
    for name in bk.KERNEL.counts:
        bk.KERNEL.counts[name] = 0
    deflate.KERNEL.counts["deflate"] = 0
    pipe_s, got = best_s(lambda: list(lt.sharded_qmf_encode_batches(batches, quality=10, device="cuda")), 1)
    launches = dict(bk.KERNEL.counts)
    check(launches == only(bk, bcd_cluster=2 * n), f"pipelined encode launched {launches}")
    check(deflate.KERNEL.counts["deflate"] == 3 * n,
          f"pipelined encode launched the DEFLATE kernel {deflate.KERNEL.counts['deflate']} times, expected {3 * n}")
    check(got == one_shot, "pipelined encode differs from the one-shot encodes")
    # steady state: the second half's batches, with the pipeline's fill and drain cancelled out
    print(f"host tail [{label}]: pipelined encode of {n} batches {n * mpix / pipe_s:.3f} Mpix/s "
          f"({pipe_s * 1e3:.1f} ms; of {n // 2} batches {half_s * 1e3:.1f} ms), steady state "
          f"{(n - n // 2) * mpix / (pipe_s - half_s):.3f} Mpix/s; one-shot encodes {n * mpix / one_s:.3f} Mpix/s "
          f"({one_s * 1e3:.1f} ms); launches {launches}; streams equal, in order")

    pack = pdec._inflate_streams(one_shot[0])[4]
    check(pack is not None and pack[:2] == (-16, 5), f"the decode upload is not bit-packed: {pack}")
    inflate_s, _ = best_s(lambda: pdec._inflate_streams(one_shot[0]))
    one_s, one_dec = best_s(lambda: [lt.sharded_qmf_decode_batch(s, device="cuda") for s in one_shot], 1)
    half_s, _ = best_s(lambda: list(lt.sharded_qmf_decode_batches(one_shot[: n // 2], device="cuda")), 1)
    pipe_s, outs = best_s(lambda: list(lt.sharded_qmf_decode_batches(one_shot, device="cuda")), 1)
    check(len(outs) == n and all(np.array_equal(a, c) for a, c in zip(outs, one_dec)),
          "pipelined decode differs from the one-shot decodes")
    print(f"host tail [{label}]: pipelined decode of {n} batches {n * mpix / pipe_s:.3f} Mpix/s "
          f"({pipe_s * 1e3:.1f} ms; of {n // 2} batches {half_s * 1e3:.1f} ms), steady state "
          f"{(n - n // 2) * mpix / (pipe_s - half_s):.3f} Mpix/s; one-shot decodes {n * mpix / one_s:.3f} Mpix/s "
          f"({one_s * 1e3:.1f} ms); host stage (parse, native inflate and {pack[1]}-bit pack) "
          f"{inflate_s * 1e3:.3f} ms per batch; pixels equal")
    return one_shot, deflate_run


def device_kernels(torch, fn) -> list[str]:
    """Names of the device kernels `fn()` launched, from `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def host_and_device_ms(torch, fn, reps: int = 3) -> tuple[float, float]:
    """(mean host CPU ms of this process, mean device ms by CUDA events) of
    `fn()`, each run starting with the device idle, after one warm-up."""
    fn()
    cpu, dev = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        c0 = time.process_time()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        cpu.append(time.process_time() - c0)
        dev.append(start.elapsed_time(end))
    return 1e3 * sum(cpu) / reps, sum(dev) / reps


def phase_fast_init(torch, lt, bk, seed: int, label: str, exact_streams, exact_dec) -> None:
    """Phase 7: `init="fast"` against the exact init on the bench batch."""
    from lrf_tpu_torch.ops import bcd as bcd_mod
    from lrf_tpu_torch.ops import color, pad, patch, resample

    images = load_images(seed)
    b, _, h, w = images.shape
    mpix = b * h * w / 1e6
    for name in bk.KERNEL.counts:
        bk.KERNEL.counts[name] = 0
    fast = lt.sharded_qmf_encode_batch(images, quality=10, device="cuda", init="fast")
    launches = dict(bk.KERNEL.counts)
    check(launches == only(bk, bcd_cluster=2), f"fast-init encode launched {launches}")
    check(lt.sharded_qmf_encode_batch(images, quality=10, device="cuda", init="fast") == fast,
          "fast-init encode is not deterministic")
    p_exact = per_image_psnr(images, exact_dec)
    p_fast = per_image_psnr(images, lt.sharded_qmf_decode_batch(fast, device="cuda"))
    delta = p_fast - p_exact
    check(bool(np.all(delta >= -0.3)), f"fast init loses more than 0.3 dB: worst {delta.min()} dB")
    print(f"fast init [{label}]: {b} of {b} images within the -0.3 dB bound; PSNR delta against the exact init "
          f"mean {delta.mean():+.4f} dB, worst {delta.min():+.4f} dB, best {delta.max():+.4f} dB; "
          f"{sum(a == c for a, c in zip(fast, exact_streams))}/{b} streams equal; launches {launches}", flush=True)

    x_dev = torch.from_numpy(images).cuda()
    chans = resample.chroma_downsample(color.rgb_to_ycbcr(x_dev), (0.5, 0.5))
    stacks = [patch.patchify(pad.pad_image(c, (8, 8)), (8, 8)) for c in chans]
    stacks = [stacks[0], torch.cat(stacks[1:], dim=0)]
    ranks = lt.build_sharded_encoder("cuda", (h, w), quality=10)[1]["rank"][:2]
    inits = {
        "svd": lambda: bcd_mod.svd_init_shared(stacks, ranks, bounds=BOUNDS),
        "fast": lambda: [bcd_mod.svd_init(x, r, method="randomized", bounds=BOUNDS) for x, r in zip(stacks, ranks)],
    }
    for mode, fn in inits.items():
        cpu_ms, dev_ms = host_and_device_ms(torch, fn)
        enc_s, _ = best_s(lambda: lt.sharded_qmf_encode_batch(images, quality=10, device="cuda", init=mode))
        names = device_kernels(torch, fn)
        ours = sum(n.startswith(("void at::", "at::")) for n in names)
        top = collections.Counter(names).most_common(6)
        libs = "cuSOLVER and cuBLAS" if mode == "fast" else "cuBLAS; its eigh runs on the host's LAPACK"
        print(f"fast init [{label}] init={mode}: init {dev_ms:.3f} ms on the device (CUDA events), {cpu_ms:.3f} ms of "
              f"host CPU; whole encode {enc_s * 1e3:.2f} ms ({mpix / enc_s:.3f} Mpix/s); the init launched "
              f"{len(names)} device kernels ({len(names) - ours} outside PyTorch's own at:: kernels, i.e. {libs}) "
              f"for {3 * b} matrices", flush=True)
        for name, n in top:
            print(f"fast init [{label}] init={mode}: kernel {n} x {name[:110]}")
    for line in sync_sites(torch, lambda: lt.sharded_qmf_encode_batch(images, quality=10, device="cuda", init="fast")):
        print(f"fast init: sync in one fast encode: {line}")


def phase_dpack(torch, lt, seed: int, label: str, streams, dec, batches) -> None:
    """Phase 8: the dpack decode transport against the flat one."""
    from lrf_tpu_torch.ops import entropy
    from lrf_tpu_torch.parallel import decode as pdec

    b = len(streams)
    _, _, h, w = dec.shape
    mpix = b * h * w / 1e6
    for k in pdec.TRANSPORT_COUNTS:
        pdec.TRANSPORT_COUNTS[k] = 0
    got = lt.sharded_qmf_decode_batch(streams, device="cuda", transport="dpack")
    counts = dict(pdec.TRANSPORT_COUNTS)
    print(f"dpack [{label}]: the bench batch took {counts}")
    check(counts == {"dpack": 1, "flat": 0, "unpacked": 0}, f"the bench batch did not take dpack: {counts}")
    check(np.array_equal(got, dec), "dpack decode differs from the one-shot decode")
    check(np.array_equal(lt.sharded_qmf_decode_batch(streams, device="cuda"), dec), "flat decode differs")

    sizes = {}
    for transport in ("flat", "dpack"):
        upload, _, shapes, _, pack = pdec._inflate_streams(streams, True, transport)
        sizes[transport] = upload.nbytes
    shapes3 = [(b, m, r) for m, r in shapes]
    c_total = entropy.segment_layout(shapes3)[2][-1]
    words = torch.from_numpy(upload.view(np.int32)).cuda()
    rows_words = -(-c_total // 4)
    main_end = rows_words + c_total * entropy.MAIN_WORDS
    rows_u8 = ((words[:rows_words, None] >> torch.arange(0, 32, 8, device="cuda")) & 0xFF).reshape(-1)[:c_total]
    unpack_ms = cuda_ms(lambda: entropy.unpack_chunks_device(rows_u8, words[rows_words:main_end], words[main_end:],
                                                             shapes3), 5)
    n_values = sum(m * r for m, r in shapes) * b
    print(f"dpack [{label}]: upload {sizes['dpack']} B ({8 * sizes['dpack'] / n_values:.4f} bits/value, {pack[2]} "
          f"continuation rows) against flat {sizes['flat']} B ({8 * sizes['flat'] / n_values:.4f}); "
          f"unpack_chunks_device {unpack_ms:.3f} ms on the device for {c_total} chunks (CUDA events, mean of 5)")
    n = len(batches)
    for k in pdec.TRANSPORT_COUNTS:
        pdec.TRANSPORT_COUNTS[k] = 0
    for transport in ("flat", "dpack", "dpack", "flat"):
        one_s, _ = best_s(lambda: lt.sharded_qmf_decode_batch(streams, device="cuda", transport=transport))
        inflate_s, _ = best_s(lambda: pdec._inflate_streams(streams, True, transport))
        pipe_s, outs = best_s(lambda: list(lt.sharded_qmf_decode_batches(batches, device="cuda", transport=transport)), 1)
        check(len(outs) == n, "pipelined decode lost a batch")
        print(f"dpack [{label}] transport={transport}: one-shot decode {mpix / one_s:.3f} Mpix/s ({one_s * 1e3:.2f} ms, "
              f"host stage {inflate_s * 1e3:.3f} ms); pipelined decode of {n} batches {n * mpix / pipe_s:.3f} Mpix/s "
              f"({pipe_s * 1e3:.1f} ms)", flush=True)
    counts = dict(pdec.TRANSPORT_COUNTS)
    print(f"dpack [{label}]: batches per transport over the timed decodes: {counts}")
    check(counts["unpacked"] == 0 and counts["dpack"] == counts["flat"], f"a timed batch left its transport: {counts}")
    check(all(np.array_equal(a, c) for a, c in zip(outs, lt.sharded_qmf_decode_batches(batches, device="cuda",
                                                                                       transport="dpack"))),
          "pipelined dpack decode differs from the pipelined flat decode")


def _equal_or_close(images, got, want, what: str) -> int:
    """Streams equal to `want`, or at least B - 2 equal and the rest within
    0.2 dB of PSNR. Returns how many are equal."""
    import lrf_tpu_torch as lt

    same = sum(a == c for a, c in zip(got, want))
    check(len(got) == len(want) and same >= len(want) - 2, f"{what}: only {same}/{len(want)} streams equal")
    for i, (a, c) in enumerate(zip(got, want)):
        if a != c:
            dp = abs(float(lt.psnr(images[i], lt.qmf_decode(a))) - float(lt.psnr(images[i], lt.qmf_decode(c))))
            check(dp < 0.2, f"{what}: image {i} differs by {dp} dB")
    return same


def dist_worker(rank: int, port: int, out_path: str, seed: int) -> int:
    """One process of phase 9's two-process run (`--dist-worker`)."""
    import datetime

    sys.path.insert(0, HERE)
    import lrf_tpu_torch as lt
    from lrf_tpu_torch.models.container import combine_bytes

    lt.initialize(init_method=f"tcp://localhost:{port}", world_size=2, rank=rank,
                  timeout=datetime.timedelta(seconds=300))
    images = load_images(seed, count=16)
    streams = lt.distributed_encode(images, lambda shard: lt.sharded_qmf_encode_batch(shard, quality=10, device="cuda"))
    if rank == 0:
        with open(out_path, "wb") as f:
            f.write(combine_bytes(streams))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def n_syncs(sites: list[str]) -> int:
    """Total count over `sync_sites`' "N x site" lines."""
    return sum(int(line.split(" x ", 1)[0]) for line in sites)


def device_spans(torch, prof) -> list[str]:
    """Per device, from a `torch.profiler` trace: kernel count, busy ms
    (kernel time summed) and the span from the first kernel's start to the
    last one's end, relative to the earliest kernel on any device."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        return ["no device kernel in the trace"]
    t0 = min(e.time_range.start for e in kernels)
    out = []
    for dev in sorted({e.device_index for e in kernels}):
        ev = [e for e in kernels if e.device_index == dev]
        busy = sum(e.time_range.end - e.time_range.start for e in ev) / 1e3
        start = (min(e.time_range.start for e in ev) - t0) / 1e3
        end = (max(e.time_range.end for e in ev) - t0) / 1e3
        out.append(f"cuda:{dev} {len(ev)} kernels, busy {busy:.3f} ms, from {start:.3f} to {end:.3f} ms")
    return out


def patch_mesh_syncs(torch, lt, images, mesh) -> tuple[list[str], list[str]]:
    """The synchronizing CUDA calls inside `sharded_bcd`'s sweep loop (run
    on the mesh's shards of the images' Y and Cb+Cr stacks, after their
    sharded init), and those of one whole patch-sharded encode."""
    from lrf_tpu_torch.ops import bcd as bcd_mod
    from lrf_tpu_torch.ops import color, pad, patch, resample

    devices = mesh.devices[0]
    x = torch.from_numpy(images).to(devices[0])
    chans = resample.chroma_downsample(color.rgb_to_ycbcr(x), (0.5, 0.5))
    stacks = [patch.patchify(pad.pad_image(c, (8, 8)), (8, 8)) for c in chans]
    stacks = [stacks[0], torch.cat(stacks[1:], dim=0)]
    ranks = lt.build_sharded_encoder("cuda", images.shape[-2:], quality=10)[1]["rank"][:2]
    shards = [[p.to(d) for p, d in zip(torch.tensor_split(s, len(devices), dim=1), devices)] for s in stacks]
    inits = bcd_mod.sharded_svd_init(shards, ranks, BOUNDS)
    loop = sync_sites(torch, lambda: [bcd_mod.sharded_bcd(xs, us, v, num_iters=ITERS, bounds=BOUNDS)
                                      for xs, (us, v) in zip(shards, inits)])
    whole = sync_sites(torch, lambda: lt.sharded_qmf_encode_batch(images, quality=10, device=mesh))
    return loop, whole


def patch_mesh_init(torch, lt, images, mesh) -> str:
    """Whether the patch mesh's init of the tall Y and merged Cb+Cr stacks
    (`sharded_svd_init`: each shard's float64 Gram summed in shard order,
    rounded once) equals one device's (`svd_init_shared`), U and V."""
    from lrf_tpu_torch.ops import bcd as bcd_mod
    from lrf_tpu_torch.ops import color, pad, patch, resample

    x = torch.from_numpy(images).cuda()
    chans = resample.chroma_downsample(color.rgb_to_ycbcr(x), (0.5, 0.5))
    stacks = [patch.patchify(pad.pad_image(c, (8, 8)), (8, 8)) for c in chans]
    stacks = [stacks[0], torch.cat(stacks[1:], dim=0)]
    ranks = lt.build_sharded_encoder("cuda", tuple(images.shape[-2:]), quality=10)[1]["rank"][:2]
    devices = mesh.devices[0]
    shards = [[p.to(d) for p, d in zip(torch.tensor_split(s, len(devices), dim=1), devices)] for s in stacks]
    out = []
    for what, (u, v, _), (us, vs) in zip(("Y", "Cb+Cr"), bcd_mod.svd_init_shared(stacks, ranks, bounds=BOUNDS),
                                         bcd_mod.sharded_svd_init(shards, ranks, BOUNDS)):
        u_sh = torch.cat([p.to(u.device) for p in us], dim=1)
        out.append(f"{what} {tuple(u.shape)} U " + ("equal" if torch.equal(u_sh, u) else
                   f"{equal_share(torch, u_sh, u):.6f} equal") + ", V " +
                   ("equal" if torch.equal(vs.to(v.device), v) else f"{equal_share(torch, vs, v):.6f} equal"))
    return "; ".join(out)


@contextlib.contextmanager
def init_eigh_windows(out: list):
    """Within the block, each call of the exact init's host eigh
    (`ops/svd.py::_lapack_eigh`, reached through `_gram_eig`) appends
    `(thread name, start, end)` on the host's `perf_counter`."""
    from lrf_tpu_torch.ops import svd

    fn = svd._lapack_eigh

    def wrapped(g, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(g, *args, **kwargs)
        finally:
            out.append((threading.current_thread().name, t0, time.perf_counter()))

    svd._lapack_eigh = wrapped
    try:
        yield
    finally:
        svd._lapack_eigh = fn


def phase_mesh(torch, lt, bk, seed: int, label: str, streams) -> None:
    """Phase 9: data and patch meshes, and two processes."""
    import socket
    import tempfile

    from lrf_tpu_torch.models.container import separate_bytes

    count = torch.cuda.device_count()
    peers = [f"{i}->{j}" for i in range(count) for j in range(count) if i != j and torch.cuda.can_device_access_peer(i, j)]
    print(f"mesh [{label}]: {count} visible CUDA device(s); peer access {peers or 'none'}")
    images = load_images(seed)
    one_s, _ = best_s(lambda: lt.sharded_qmf_encode_batch(images, quality=10, device="cuda"))
    print(f"mesh [{label}]: one card (cuda:0) encodes the {len(images)} images in {one_s * 1e3:.2f} ms (best of 3)")
    meshes = [lt.make_mesh()]
    if count == 1:
        meshes.append(lt.make_mesh(data=2, devices=["cuda:0", "cuda:0"]))
    for mesh in meshes:
        for name in bk.KERNEL.counts:
            bk.KERNEL.counts[name] = 0
        got = lt.sharded_qmf_encode_batch(images, quality=10, device=mesh)
        launches = dict(bk.KERNEL.counts)
        rows = mesh.shape["data"]
        check(launches == only(bk, bcd_cluster=2 * rows), f"{mesh}: launches {launches}")
        same = _equal_or_close(images, got, streams, f"data mesh {mesh}")
        t, _ = best_s(lambda: lt.sharded_qmf_encode_batch(images, quality=10, device=mesh))
        dec = lt.sharded_qmf_decode_batch(got, device=mesh)
        check(all(np.array_equal(dec[i], lt.qmf_decode(s)) for i, s in enumerate(got)), f"{mesh}: decode differs")
        print(f"mesh [{label}]: data mesh {mesh}: {same}/{len(got)} streams equal to one device's; cluster-kernel "
              f"launches {launches['bcd_cluster'] // rows} per shard ({rows} shards); encode {t * 1e3:.2f} ms (best of 3) "
              f"against {one_s * 1e3:.2f} ms on one card in this run ({one_s / t:.3f}x)", flush=True)
        if rows > 1:
            windows = []
            with init_eigh_windows(windows):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lt.sharded_qmf_encode_batch(images, quality=10, device=mesh)
                call_ms = (time.perf_counter() - t0) * 1e3
            check(len({w[0] for w in windows}) == rows, f"{mesh}: init eighs on {len(windows)} threads, not {rows}")
            spans = ", ".join(f"{name} {(a - t0) * 1e3:.2f}-{(b - t0) * 1e3:.2f}"
                              for name, a, b in sorted(windows, key=lambda w: w[1]))
            shared = sum(any(o[0] != w[0] and o[1] < w[2] and w[1] < o[2] for o in windows) for w in windows)
            print(f"mesh [{label}]: data mesh {mesh}: the rows' init eighs (ms from the encode's start, one host "
                  f"clock; the call {call_ms:.2f} ms): {spans}; {shared} of {len(windows)} overlap another row's",
                  flush=True)
            with lt.trace(os.path.join(HERE, "chiprun_out", "traces")) as prof:
                lt.sharded_qmf_encode_batch(images, quality=10, device=mesh)
            for line in device_spans(torch, prof):
                print(f"mesh [{label}]: data mesh {mesh} traced: {line}")

    small = images[:8]
    want = lt.sharded_qmf_encode_batch(small, quality=10, device="cuda")
    cards = [f"cuda:{i}" for i in range(count)]
    patch_mesh = lt.make_mesh(data=1, patch=2, devices=cards[:2] if count >= 2 else ["cuda:0", "cuda:0"])
    launches = bk.KERNEL.launches
    first, got = best_s(lambda: lt.sharded_qmf_encode_batch(small, quality=10, device=patch_mesh), 1)
    check(bk.KERNEL.launches == launches, "the patch-sharded encode launched a BCD kernel")
    t, again = best_s(lambda: lt.sharded_qmf_encode_batch(small, quality=10, device=patch_mesh))
    check(got == again, "patch-sharded encode not deterministic")
    dp = per_image_psnr(small, lt.sharded_qmf_decode_batch(got, device=patch_mesh)) - per_image_psnr(
        small, lt.sharded_qmf_decode_batch(want, device="cuda"))
    check(bool(np.all(np.abs(dp) < 0.2)), f"patch-sharded PSNR differs by up to {np.abs(dp).max()} dB")
    init_equal = patch_mesh_init(torch, lt, small, patch_mesh)
    loop_syncs, encode_syncs = patch_mesh_syncs(torch, lt, small, patch_mesh)
    print(f"mesh [{label}]: patch mesh {patch_mesh} on {len(small)} x 512x768: plain sweeps across 2 shards (0 kernel "
          f"launches), {t * 1e3:.1f} ms (best of 3; first call {first * 1e3:.1f} ms); syncs inside sharded_bcd's sweep "
          f"loop {n_syncs(loop_syncs)}, in the whole encode {n_syncs(encode_syncs)}; PSNR within "
          f"{np.abs(dp).max():.6f} dB of the unsharded encode (mean {dp.mean():+.6f}); "
          f"{sum(a == c for a, c in zip(got, want))}/{len(small)} streams equal; its init (U, V before the sweeps) "
          f"against one device's: {init_equal}", flush=True)
    for line in loop_syncs + encode_syncs:
        print(f"mesh [{label}]: patch mesh sync: {line}")
    check(not loop_syncs, f"sharded_bcd's sweep loop synchronized with the host: {loop_syncs}")
    with lt.trace(os.path.join(HERE, "chiprun_out", "traces")) as prof:
        lt.sharded_qmf_encode_batch(small, quality=10, device=patch_mesh)
    table = prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12, max_name_column_width=48)
    print(f"mesh [{label}]: patch mesh traced (torch.profiler, ops by host self time):\n{table}")
    for line in device_spans(torch, prof):
        print(f"mesh [{label}]: patch mesh traced: {line}")

    data16 = load_images(seed, count=16)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "streams.bin")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed", str(seed), "--dist-worker",
                                   str(rank), str(port), out_path]) for rank in range(2)]
        try:
            codes = [p.wait(timeout=400) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(codes == [0, 0], f"two-process encode exited {codes}")
        with open(out_path, "rb") as f:
            got = list(separate_bytes(f.read(), 16))
        dist_s = time.perf_counter() - t0
    shards = (lt.sharded_qmf_encode_batch(data16[:8], quality=10, device="cuda")
              + lt.sharded_qmf_encode_batch(data16[8:], quality=10, device="cuda"))
    check(got == shards, "two-process streams differ from one process's encodes of the same shards")
    whole = lt.sharded_qmf_encode_batch(data16, quality=10, device="cuda")
    print(f"mesh [{label}]: two-process distributed_encode (gloo, both on the card) of 16 x 512x768: streams in order, "
          f"16/16 equal to one process's encodes of the two shards, {sum(a == c for a, c in zip(got, whole))}/16 equal "
          f"to its encode of all 16; {dist_s:.1f} s with process start-up", flush=True)


QUALITIES = (10, 25, 40, 75)
# Per-image launches that phase 10 requires at the qualities whose Y stack
# left the R <= 16 cluster kernel: q40 Y on the wide cluster kernel, q75 Y
# on bcd_grid and its Cb and Cr (R = 24) on the wide cluster kernel.
PATH_LAUNCHES = {40: {"bcd_cluster_wide": 1, "bcd_cluster": 2}, 75: {"bcd_grid": 1, "bcd_cluster_wide": 2}}


def phase_eval(torch, lt, bk, seed: int, label: str, main_run) -> dict:
    """Phase 10: `eval_compression` of 4 bench images at q10, q25, q40 and
    q75 on the card, the kernel each stack launched, card metrics against
    CPU metrics, the planned kernel at every per-image stack (the planned
    kernel and `bcd.cu` in turns at the q40 and q75 Y stacks), batched q40
    and q75 encodes against plain-BCD ones, and `device_benchmark` of the
    bench encode against phase 4's three calls. Returns, per quality of
    PATH_LAUNCHES, the Y stack's timing entry with the launches counted
    over that quality's per-image encodes."""
    from lrf_tpu_torch.ops import bcd as bcd_mod
    from lrf_tpu_torch.ops import color, pad, patch, resample
    from lrf_tpu_torch.utils import metrics as tm

    images = load_images(seed)
    _, _, h, w = images.shape
    chroma = resample.scaled_size((h, w), (0.5, 0.5))
    ms = [(h // 8) * (w // 8), (chroma[0] // 8) * (chroma[1] // 8), (chroma[0] // 8) * (chroma[1] // 8)]
    device_ms = {}
    ranks = {}
    path_launches = {q: only(bk) for q in PATH_LAUNCHES}
    for q in QUALITIES:
        ranks[q] = lt.build_sharded_encoder("cuda", (h, w), quality=q)[1]["rank"]
        plans = [bk.KERNEL.plan(m, 64, r).variant for m, r in zip(ms, ranks[q])]
        want = {name: plans.count(name) for name in bk.KERNEL.counts}
        if q in PATH_LAUNCHES:
            check(want == only(bk, **PATH_LAUNCHES[q]), f"q{q}: the plan gives {want}, expected {PATH_LAUNCHES[q]}")
        stacks = ", ".join(f"{c} (1, {m}, 64, {r}) -> {v}"
                           for c, m, r, v in zip(("Y", "Cb", "Cr"), ms, ranks[q], plans))
        print(f"eval [{label}] q{q}: stacks per image {stacks}", flush=True)
        device_ms[q] = []
        for i, img in enumerate(images[:4]):
            for name in bk.KERNEL.counts:
                bk.KERNEL.counts[name] = 0
            out = lt.eval_compression(img, lt.qmf_encode, lt.qmf_decode, reconstruct=True, device="cuda", quality=q)
            counts = dict(bk.KERNEL.counts)
            check(counts == want, f"q{q} image {i}: launches {counts}, expected {want}")
            if q in path_launches:
                path_launches[q] = {k: path_launches[q][k] + counts[k] for k in counts}
            rec = out["reconstructed"]
            cpu = {"PSNR (dB)": float(tm.psnr(torch.from_numpy(img), torch.from_numpy(rec))),
                   "SSIM": float(tm.ssim(torch.from_numpy(img), torch.from_numpy(rec)))}
            for key, value in cpu.items():
                check(abs(out[key] - value) <= 1e-5 * abs(value), f"q{q} image {i}: {key} {out[key]} on the card, "
                      f"{value} on the CPU")
            check(np.isfinite(out["PSNR (dB)"]) and out["PSNR (dB)"] > 15, f"q{q} image {i}: PSNR {out['PSNR (dB)']}")
            device_ms[q].append(out["encoding device time (ms)"])
            print(f"eval [{label}] q{q} image {i}: {out['bit rate (bpp)']:.4f} bpp, PSNR {out['PSNR (dB)']:.4f} dB, "
                  f"SSIM {out['SSIM']:.6f} (CPU {cpu['PSNR (dB)']:.4f} dB, {cpu['SSIM']:.6f}); encode "
                  f"{out['encoding time (ms)']:.2f} ms ({out['encoding device time (ms)']:.3f} ms device), decode "
                  f"{out['decoding time (ms)']:.2f} ms; launches {counts}; {out['platform']}", flush=True)
        if q in path_launches:
            print(f"eval [{label}] q{q}: launches over the 4 per-image encodes {path_launches[q]}", flush=True)

    # Batched encodes of the 64 bench images at q40 and q75: Y (64, 6144, 64,
    # R) on its planned kernel, merged Cb+Cr (128, 1536, 64, R / 2) on its
    # own; per-image PSNR within 0.2 dB of an encode whose BCD is the plain
    # version.
    for q in PATH_LAUNCHES:
        want = {name: 0 for name in bk.KERNEL.counts}
        for m, r in ((ms[0], ranks[q][0]), (ms[1], ranks[q][1])):
            want[bk.KERNEL.plan(m, 64, r).variant] += 1
        for name in bk.KERNEL.counts:
            bk.KERNEL.counts[name] = 0
        streams = lt.sharded_qmf_encode_batch(images, quality=q, device="cuda")
        batch_launches = dict(bk.KERNEL.counts)
        check(batch_launches == want, f"batched q{q} encode launched {batch_launches}, expected {want}")
        enc_s, again = best_s(lambda: lt.sharded_qmf_encode_batch(images, quality=q, device="cuda"))
        check(again == streams, f"batched q{q} encode is not deterministic")
        plain = lt.sharded_qmf_encode_batch(images, quality=q, device="cuda", backend="torch")
        p_kernel = per_image_psnr(images, lt.sharded_qmf_decode_batch(streams, device="cuda"))
        p_plain = per_image_psnr(images, lt.sharded_qmf_decode_batch(plain, device="cuda"))
        worst = float(np.abs(p_kernel - p_plain).max())
        check(worst < 0.2, f"batched q{q}: PSNR differs from the plain-BCD encode by {worst} dB")
        print(f"eval [{label}] q{q} batched encode of {len(images)} images: launches {batch_launches}; "
              f"{enc_s * 1e3:.2f} ms (best of 3); PSNR mean {p_kernel.mean():.4f} dB, max |dPSNR| against the "
              f"plain-BCD encode {worst:.6f} dB, {sum(a == c for a, c in zip(streams, plain))}/{len(images)} streams "
              f"byte-identical", flush=True)

    # The planned kernel at each per-image stack of image 0 (Y, and Cb, whose
    # shape and rank Cr shares), as `qmf_encode` runs it; at the q40 and q75
    # Y stacks the planned kernel and bcd.cu in turns.
    x = torch.from_numpy(images[:1]).cuda()
    planes = resample.chroma_downsample(color.rgb_to_ycbcr(x), (0.5, 0.5))
    stacks = [patch.patchify(pad.pad_image(c, (8, 8)), (8, 8)).contiguous() for c in planes[:2]]
    timed = {}
    for q in QUALITIES:
        enc_dev = float(np.median(device_ms[q]))
        for name, y, r in zip(("Y", "Cb"), stacks, ranks[q][:2]):
            u0, v0, _ = bcd_mod.svd_init(y, r, bounds=BOUNDS)
            ur, vr = bk.bcd_reference(y, u0, v0, num_iters=ITERS, bounds=BOUNDS)
            shape = tuple(y.shape) + (r,)
            planned = bk.KERNEL.plan(*shape[1:]).variant
            variants = [planned, "bcd"] if q in PATH_LAUNCHES and name == "Y" else [planned]
            entry = dict(shape=shape, variant=planned, err={}, eq={})
            for variant in variants:
                uk, vk = run_variant(bk, y, u0, v0, BOUNDS, variant)
                entry["err"][variant] = max(float((uk - ur).abs().max()), float((vk - vr).abs().max()))
                entry["eq"][variant] = min(float((uk == ur).float().mean()), float((vk == vr).float().mean()))
                check(entry["eq"][variant] > 0.85, f"{variant} at the q{q} {name} stack: equal share {entry['eq']}")
            entry["ms"] = (time_pair(bk, y, u0, v0, 20, 10) if len(variants) == 2
                           else {planned: cuda_ms(lambda: run_variant(bk, y, u0, v0, BOUNDS, planned), 20)})
            entry["plain_ms"] = cuda_ms(lambda: bk.bcd_reference(y, u0, v0, num_iters=ITERS), 3)
            entry["bound_ms"], entry["bound_by"] = bcd_bound_ms(*shape, ITERS)
            timed[(q, name)] = entry
            times = "; ".join(f"{v} {t:.4f} ms ({100 * entry['bound_ms'] / t:.2f}% of bound, {100 * t / enc_dev:.2f}% "
                              f"of the median q{q} encode's {enc_dev:.3f} device ms), max|diff| {entry['err'][v]:g}, "
                              f"equal share {entry['eq'][v]:.5f}" for v, t in entry["ms"].items())
            print(f"eval [{label}] q{q} {name} stack {shape}, {1 if name == 'Y' else 2} launch(es) per image encode: "
                  f"{times}; plain {entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.6g} ms "
                  f"({entry['bound_by']})", flush=True)
    paths = {q: dict(timed[(q, "Y")], launches=path_launches[q]) for q in PATH_LAUNCHES}

    # device_benchmark of the bench encode (taken in phase 4, right after its
    # three timed calls) against those three calls
    db = main_run["bench"]
    p4 = main_run["enc_all_ms"]
    spread = max(p4) - min(p4)
    gap = abs(db["min_ms"] - min(p4))
    print(f"eval [{label}]: device_benchmark of the {len(images)}-image q10 encode: min {db['min_ms']:.2f} ms, mean "
          f"{db['mean_ms']:.2f} +- {db['std_ms']:.2f} ms ({db['mpixels_per_s']:.3f} Mpix/s); phase 4's three calls "
          f"{', '.join(f'{t:.2f}' for t in p4)} ms (spread {spread:.2f}); best against best {gap:.2f} ms apart", flush=True)
    check(gap <= max(spread, 2 * db["std_ms"]), f"device_benchmark {db['min_ms']:.2f} ms disagrees with phase 4's "
          f"{min(p4):.2f} ms beyond the spread {spread:.2f} ms")
    return paths


def close_pixels(a: np.ndarray, b: np.ndarray, what: str) -> None:
    """The cross-decode contract: at most 1 apart, in under 0.1% of pixels."""
    check(a.shape == b.shape and a.dtype == b.dtype == np.uint8, f"{what}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    check(int(diff.max()) <= 1 and float((diff > 0).mean()) < 1e-3,
          f"{what}: max |diff| {int(diff.max())}, {float((diff > 0).mean()):.5f} of pixels differ")


def column_signs(torch, a, b):
    """(the sign of each column of `a` against the same column of `b`, the
    least |cos| between matched columns); columns run over dim -2."""
    b = b.to(a.device)
    cos = (a * b).sum(-2) / (a.norm(dim=-2) * b.norm(dim=-2)).clamp(min=1e-30)
    return torch.where(cos < 0, -1.0, 1.0), float(cos.abs().min())


def relative_gap(torch, a, b) -> float:
    b = b.to(a.device)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def align_svd(torch, card, cpu):
    """The card's `(u, v)` with the CPU's signs, and `(least |cos|, relative
    gap, components whose sign differs, components, leading component
    negative on the card, on the CPU)`; a component is negative where its
    u column sums below 0."""
    (u, v), (u_cpu, v_cpu) = card, cpu
    sign, cos = column_signs(torch, u, u_cpu)
    gap = relative_gap(torch, u @ v.transpose(-1, -2), u_cpu @ v_cpu.transpose(-1, -2))
    lead = (float(u[..., 0].sum()) < 0, float(u_cpu[..., 0].sum()) < 0)
    return (u * sign[..., None, :], v * sign[..., None, :]), (cos, gap, int((sign < 0).sum()), sign.numel(), *lead)


def align_hosvd(torch, card, cpu):
    from lrf_tpu_torch.ops.hosvd import multi_mode_product

    (core, factors), (core_cpu, cpu_factors) = card, cpu
    gap = relative_gap(torch, multi_mode_product(core, factors), multi_mode_product(core_cpu, cpu_factors))
    out, worst = [], 1.0
    for mode, (f, g) in enumerate(zip(factors, cpu_factors)):
        sign, cos = column_signs(torch, f, g)
        worst = min(worst, cos)
        out.append(f * sign)
        core = core * sign.reshape([-1 if d == mode else 1 for d in range(core.ndim)])
    return (core, out), (worst, gap)


class cpu_signs:
    """Within the block, `mod.name(x, ...)` gives its result on x's device
    with each component's sign set to the one it takes on the CPU, as
    `align` matches them; `(least |cos| of the matched columns, relative gap
    of the reconstructions)` of each call goes to `worst`. The factors'
    signs are the eigen- or SVD solver's own, and the codecs' truncating
    quantizers are not sign-free, so this is how a card stream is held to a
    CPU stream. Trailing components of near-equal singular values are
    ill-posed one by one, so the factors are held by their (sign-free)
    reconstruction, and the |cos| is printed. `align` returns the aligned
    result and a tuple that starts `(least |cos|, relative gap)`."""

    def __init__(self, torch, mod, name: str, align, worst: list):
        self.torch, self.mod, self.name, self.align, self.worst = torch, mod, name, align, worst

    def __enter__(self):
        fn = self.fn = getattr(self.mod, self.name)

        def wrapped(x, *args, **kwargs):
            out, cos = self.align(self.torch, fn(x, *args, **kwargs), fn(x.cpu(), *args, **kwargs))
            self.worst.append(cos)
            return out

        setattr(self.mod, self.name, wrapped)

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)


@contextlib.contextmanager
def debiased(mod):
    """Within the block, `mod`'s decoders dequantize each factor with half a
    step added: the truncating quantizer leaves every entry of a factor on
    average half a step (scale / 2) low, and at pixel (i, j) of U V^T that
    bias sums to -(scale_u / 2) sum_k V[j, k] - (scale_v / 2) sum_k U[i, k]
    + R scale_u scale_v / 4, which depends on each component's sign. With the
    half step added the bias is gone, and what is left of the PSNR gap that
    the solvers' signs leave comes from the quantization scales they move.
    A reading of the mechanism only: the codecs' decoders and format stay
    as they are."""
    fn = mod.np_dequantize
    mod.np_dequantize = lambda q, scale, min_val: fn(q, scale, min_val) + np.float32(scale) / 2
    try:
        yield
    finally:
        mod.np_dequantize = fn


# Per phase-11 SVD setting, the card's encode ms per image (median of 8) and
# the card - CPU PSNR of its own streams (mean, worst over the 8 bench
# images), read while the codec factored through torch.linalg.svd
# (cuSOLVER on the card, torch's LAPACK on the CPU) with a leading-sign
# rule; NVIDIA H100 80GB HBM3, 700.00 W.
SVD_BEFORE = {("RGB", 10): (9.65, -0.0004, -0.0352), ("RGB", 50): (17.92, +0.0217, -0.2549),
              ("YCbCr", 10): (12.03, +0.0042, -0.0113), ("YCbCr", 50): (14.48, +0.0433, +0.0014)}


# The card's own streams (no sign patched in) against the CPU's: the SVD
# codec's PSNR within SVD_GAP_DB per image, the HOSVD codecs' within
# HOSVD_GAP_DB. Both codecs factor through the host's LAPACK on every
# device (`ops/svd.py::_lapack_svd`, `_lapack_eigh`) and quantize with a
# tensor divisor, and the card's X is the CPU's, so the SVD streams are
# predicted byte-identical. These replace a bound of 2 dB below the CPU
# (RAW_GAP_DB), set while the card's solver picked its own signs; the
# readings then were -0.2549 dB (SVD RGB q50, torch.linalg.svd) and -0.0029
# / -0.0033 / -0.0282 dB (HOSVD), NVIDIA H100 80GB HBM3, 700.00 W.
SVD_GAP_DB = 0.01
HOSVD_GAP_DB = 0.1
# Per phase-11 HOSVD setting, the card's own PSNR minus the CPU's (dB) and
# the card's encode ms, read on the same image before the codecs' mode eigh
# went to the host's LAPACK (an earlier run read -0.52, +1.05 and +1.95 dB);
# NVIDIA H100 80GB HBM3, 700.00 W.
HOSVD_BEFORE = ((-0.5164, 25.72), (+1.0482, 17.01), (+1.9485, 52.88))


@contextlib.contextmanager
def host_eigh(torch, out: list):
    """Within the block, each mode eigh of the HOSVD codecs (`ops/hosvd.py`'s
    `_lapack_eigh`: the Gram to the host, LAPACK's ?syevd, the result back)
    appends `(host-clock seconds from an idle device, Gram order n)` to
    `out`."""
    import importlib

    mod = importlib.import_module("lrf_tpu_torch.ops.hosvd")
    fn = mod._lapack_eigh

    def wrapped(g):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(g)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0, g.shape[-1]))
        return result

    mod._lapack_eigh = wrapped
    try:
        yield
    finally:
        mod._lapack_eigh = fn


def run_cli(cli, *argv) -> str:
    """`lrf_tpu_torch.cli.main(argv)` in this process; its standard output."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    check(rc == 0, f"cli {' '.join(argv)}: exit code {rc}")
    return out.getvalue()


def phase_cli(torch, lt, bk, img: np.ndarray, label: str, tmp: str) -> None:
    """Phase 11, the CLI: encode / decode / info / eval of a 512x768 PNG at
    q10 in this process, once more as `python -m lrf_tpu_torch`, and the
    SVD codec once."""
    from PIL import Image

    from lrf_tpu_torch import cli

    png = os.path.join(tmp, "img.png")
    Image.fromarray(np.ascontiguousarray(img.transpose(1, 2, 0))).save(png)
    stream_path = os.path.join(tmp, "img.lrf")
    for name in bk.KERNEL.counts:
        bk.KERNEL.counts[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli(cli, "encode", png, stream_path, "--quality", "10")
    enc_s = time.perf_counter() - t0
    launches = dict(bk.KERNEL.counts)
    check(launches == only(bk, bcd_cluster=3), f"cli encode launched {launches}, expected bcd_cluster 3 times")
    with open(stream_path, "rb") as f:
        stream = f.read()
    check(stream == lt.qmf_encode(img, quality=10, device="cuda"), "cli stream differs from qmf_encode's")
    out_png = os.path.join(tmp, "round.png")
    t0 = time.perf_counter()
    run_cli(cli, "decode", stream_path, out_png)
    dec_s = time.perf_counter() - t0
    dec = np.asarray(Image.open(out_png).convert("RGB")).transpose(2, 0, 1)
    check(np.array_equal(dec, lt.qmf_decode(stream, device="cuda")), "cli decode differs from qmf_decode")
    info = json.loads(run_cli(cli, "info", stream_path))
    check(info["codec"] == "qmf" and info["bytes"] == len(stream) and info["rank"] == [6, 3, 3], f"cli info {info}")
    result = json.loads(run_cli(cli, "eval", png, "--quality", "10"))
    check(np.isfinite(result["PSNR (dB)"]) and result["PSNR (dB)"] > 15 and result["platform"].startswith("cuda"),
          f"cli eval {result}")
    again = os.path.join(tmp, "again.lrf")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lrf_tpu_torch", "encode", png, again, "--quality", "10"],
                          cwd=HERE, capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m lrf_tpu_torch encode: exit {proc.returncode}: {proc.stderr[-2000:]}")
    with open(again, "rb") as f:
        check(f.read() == stream, "python -m lrf_tpu_torch wrote another stream")
    svd_path, svd_png = os.path.join(tmp, "img.svd.lrf"), os.path.join(tmp, "svd.png")
    run_cli(cli, "encode", png, svd_path, "--codec", "svd", "--quality", "10")
    run_cli(cli, "decode", svd_path, svd_png)
    with open(svd_path, "rb") as f:
        svd_stream = f.read()
    check(json.loads(run_cli(cli, "info", svd_path))["codec"] == "svd", "cli info does not detect the SVD stream")
    svd_dec = np.asarray(Image.open(svd_png).convert("RGB")).transpose(2, 0, 1)
    check(np.array_equal(svd_dec, lt.svd_decode(svd_stream, device="cuda")), "cli SVD decode differs from svd_decode")
    print(f"cli [{label}]: encode of a 512x768 PNG at q10 launched {launches}, {len(stream)} B equal to qmf_encode's, "
          f"{enc_s * 1e3:.1f} ms in process (PNG read and file write included); decode {dec_s * 1e3:.1f} ms, pixels "
          f"equal to qmf_decode's; info and eval JSON ok (eval PSNR {result['PSNR (dB)']:.4f} dB, {result['platform']}); "
          f"python -m lrf_tpu_torch encode exit 0, same bytes, {sub_s:.1f} s with process start-up; --codec svd "
          f"{len(svd_stream)} B, detected and decoded", flush=True)


def phase_svd_codec(torch, lt, images: np.ndarray, label: str) -> None:
    """Phase 11, the SVD codec on 8 bench images, RGB patches (the default)
    and YCbCr at q10 and q50: card streams decode on the CPU and CPU streams
    on the card (the cross-decode contract); the card's U V^T is within 1e-3
    of the CPU's (relative), and with the CPU's signs the card stream's PSNR
    is within 0.1 dB of the CPU stream's. The codec factors through the
    host's LAPACK on every device, so the card's own stream is within
    SVD_GAP_DB of the CPU's. How many streams are byte-identical, the
    encode ms beside SVD_BEFORE's, the gap with both decoded `debiased`, and
    how many components the card's factorization signs otherwise, are
    printed."""
    from lrf_tpu_torch.models import svd as msvd

    for kw in (dict(quality=10), dict(quality=10, color_space="YCbCr")):  # warm-up: scipy, the coder
        lt.svd_decode(lt.svd_encode(images[0], device="cuda", **kw), device="cuda")
    identical, streams = 0, 0
    for color_space in ("RGB", "YCbCr"):
        for q in (10, 50):
            kw = dict(quality=q, color_space=color_space)
            enc_ms, dec_ms, raw, aligned, unbiased, worst, same = [], [], [], [], [], [], []
            for i, img in enumerate(images):
                t_enc, s_card = best_s(lambda: lt.svd_encode(img, device="cuda", **kw), reps=1)
                t_dec, d_card = best_s(lambda: lt.svd_decode(s_card, device="cuda"), reps=1)
                enc_ms.append(t_enc * 1e3)
                dec_ms.append(t_dec * 1e3)
                s_cpu = lt.svd_encode(img, device="cpu", **kw)
                same.append(s_card == s_cpu)
                d_cpu = lt.svd_decode(s_cpu, device="cpu")
                close_pixels(lt.svd_decode(s_card, device="cpu"), d_card, f"SVD {color_space} q{q} image {i} card stream")
                close_pixels(lt.svd_decode(s_cpu, device="cuda"), d_cpu, f"SVD {color_space} q{q} image {i} CPU stream")
                with cpu_signs(torch, msvd, "_balanced_factors", align_svd, worst):
                    s_aligned = lt.svd_encode(img, device="cuda", **kw)
                p_cpu = float(per_image_psnr(img, d_cpu))
                raw.append(float(per_image_psnr(img, d_card)) - p_cpu)
                aligned.append(float(per_image_psnr(img, lt.svd_decode(s_aligned, device="cuda"))) - p_cpu)
                with debiased(msvd):
                    unbiased.append(float(per_image_psnr(img, lt.svd_decode(s_card, device="cuda")))
                                    - float(per_image_psnr(img, lt.svd_decode(s_cpu, device="cuda"))))
            identical += sum(same)
            streams += len(same)
            cos, gap = min(w[0] for w in worst), max(w[1] for w in worst)
            flipped, components = sum(w[2] for w in worst), sum(w[3] for w in worst)
            lead_card, lead_cpu = sum(w[4] for w in worst), sum(w[5] for w in worst)
            print(f"svd [{label}] {color_space} q{q}, 8 x 512x768: encode {np.median(enc_ms):.2f} ms per image (median; "
                  f"min {min(enc_ms):.2f}, max {max(enc_ms):.2f}), decode {np.median(dec_ms):.2f} ms; cross-decode ok; "
                  f"U V^T within {gap:.3g} of the CPU's (relative), factors' least |cos| {cos:.6f}; card - CPU "
                  f"PSNR with the CPU's signs max |d| "
                  f"{max(abs(d) for d in aligned):.6f} dB, with the card's own {min(raw):+.6f}..{max(raw):+.6f} "
                  f"dB (mean {np.mean(raw):+.6f}), decoded debiased max |d| {max(abs(d) for d in unbiased):.6f} dB; "
                  f"signs apart in {flipped} of {components} components, the leading component negative in "
                  f"{lead_card} of {len(worst)} factorizations on the card, {lead_cpu} on the CPU", flush=True)
            before = SVD_BEFORE[(color_space, q)]
            worst_i = int(np.argmin(raw))
            print(f"svd [{label}] {color_space} q{q}, host LAPACK: {sum(same)} of {len(same)} streams byte-identical to "
                  f"the CPU's; card - CPU PSNR mean {np.mean(raw):+.6f} dB, worst {raw[worst_i]:+.6f} dB (image "
                  f"{worst_i}); encode {np.median(enc_ms):.2f} ms; before, through torch.linalg.svd with the sign "
                  f"rule: mean {before[1]:+.4f}, worst {before[2]:+.4f} dB, encode {before[0]:.2f} ms", flush=True)
            check(gap < 1e-3, f"SVD {color_space} q{q}: card U V^T off the CPU's by {gap} (relative)")
            check(max(abs(d) for d in aligned) < 0.1, f"SVD {color_space} q{q}: with the CPU's signs the card's PSNR is "
                  f"off the CPU's by {aligned} dB")
            check(max(abs(d) for d in raw) < SVD_GAP_DB, f"SVD {color_space} q{q}: the card's own streams' PSNR is off "
                  f"the CPU's by {raw} dB, beyond {SVD_GAP_DB}")
    print(f"svd [{label}] streams byte-identical card against CPU: {identical} of {streams} (8 images x RGB, YCbCr x "
          f"q10, q50)", flush=True)


def phase_hosvd_tt(torch, lt, img: np.ndarray, label: str) -> None:
    """Phase 11, HOSVD at com_ratio 50, patch-HOSVD with its SSIM rank search
    at bpp 0.5 (8x8 patches, one feasible r1) and at bpp 1 (16x16 patches,
    11), and TT on one 512x768 image, card against CPU. The card's own PSNR
    is within HOSVD_GAP_DB of the CPU's; that gap is printed beside its
    reading before the mode eigh went to the host (HOSVD_BEFORE), with the
    encode ms and the host eigh's share of them, and the gap with both
    decoded `debiased`."""
    from lrf_tpu_torch.models import hosvd as mhosvd

    lt.hosvd_decode(lt.hosvd_encode(img, com_ratio=50, device="cuda"), device="cuda")  # warm-up
    # the codecs' input: the card's unit-float image must be the CPU's, bit
    # for bit, or the mode eigensolver's signs may follow the last bits
    unit = mhosvd._to_unit_float(torch.from_numpy(img).cuda()).cpu()
    unit_cpu = mhosvd._to_unit_float(torch.from_numpy(img))
    check(torch.equal(unit, unit_cpu), "the card's unit-float image differs from the CPU's")
    scalar = (torch.from_numpy(img).cuda().to(torch.float32) / 255.0).cpu()
    print(f"hosvd [{label}]: the unit-float image: divided by a Python scalar on the card, "
          f"{int((scalar != unit_cpu).sum())} of {unit_cpu.numel()} entries differ from the CPU's quotient; "
          f"divided by a tensor on the card, 0", flush=True)
    for (name, encode, decode, kw), (gap_before, ms_before) in zip((
        ("hosvd", lt.hosvd_encode, lt.hosvd_decode, dict(com_ratio=50)),
        ("patch hosvd", lt.patch_hosvd_encode, lt.patch_hosvd_decode, dict(bpp=0.5)),
        ("patch hosvd", lt.patch_hosvd_encode, lt.patch_hosvd_decode, dict(bpp=1.0, patch_size=(16, 16))),
    ), HOSVD_BEFORE):
        t_enc, d_card = best_s(lambda: encode(img, device="cuda", **kw), reps=1)
        eighs = []
        with host_eigh(torch, eighs):
            encode(img, device="cuda", **kw)
        t_dec, x_card = best_s(lambda: decode(d_card, device="cuda"), reps=1)
        d_cpu = encode(img, device="cpu", **kw)
        x_cpu = decode(d_cpu, device="cpu")
        ranks_card = [f[0].shape[-1] for f in d_card["factors"]]
        ranks_cpu = [f[0].shape[-1] for f in d_cpu["factors"]]
        close_pixels(decode(d_card, device="cpu"), x_card, f"{name} {kw} card dict")
        close_pixels(decode(d_cpu, device="cuda"), x_cpu, f"{name} {kw} CPU dict")
        worst = []
        with cpu_signs(torch, mhosvd, "hosvd", align_hosvd, worst):
            # the CPU's ranks given, so that the aligned run skips the search
            fixed = dict(kw, rank=tuple(ranks_cpu), bpp=None) if name == "patch hosvd" else kw
            x_al = decode(encode(img, device="cuda", **fixed), device="cuda")
        p_cpu = float(per_image_psnr(img, x_cpu))
        d_raw = float(per_image_psnr(img, x_card)) - p_cpu
        d_al = float(per_image_psnr(img, x_al)) - p_cpu
        with debiased(mhosvd):
            d_unb = (float(per_image_psnr(img, decode(d_card, device="cuda")))
                     - float(per_image_psnr(img, decode(d_cpu, device="cuda"))))
        rank_note = ""
        if name == "patch hosvd":
            ps = kw.get("patch_size", (8, 8))
            com_ratio = 8 * img.dtype.itemsize * img.shape[0] / kw["bpp"]
            xf = mhosvd._to_unit_float(torch.from_numpy(img).cuda())
            search_s, (rank, scored, score) = best_s(lambda: mhosvd._optimal_rank(xf, com_ratio, ps), reps=1)
            _, scored_cpu, score_cpu = mhosvd._optimal_rank(mhosvd._to_unit_float(torch.from_numpy(img)), com_ratio, ps)
            check(list(rank) == ranks_card, f"search rank {rank} is not the encode's {ranks_card}")
            check(scored == scored_cpu, f"{name} {kw}: {scored} candidates scored on the card, {scored_cpu} on the CPU")
            held = "the same rank"
            if ranks_card != ranks_cpu:  # a near-tie of the SSIM scores may pick another rank
                check(abs(score - score_cpu) <= 1e-5, f"{name} {kw}: rank {ranks_card} on the card, {ranks_cpu} on "
                      f"the CPU, best SSIM {score} against {score_cpu}")
                held = "another rank, best SSIM within 1e-5"
            rank_note = (f"; the rank search scored {scored} candidates in {search_s * 1e3:.1f} ms (one SSIM read "
                         f"each), best SSIM {score:.7f} (CPU {score_cpu:.7f}): {held}")
        else:
            check(ranks_card == ranks_cpu, f"{name}: rank {ranks_card} on the card, {ranks_cpu} on the CPU")
        cos, gap = min(c for c, _ in worst), max(g for _, g in worst)
        print(f"{name} [{label}] {kw}: ranks {ranks_card} (CPU {ranks_cpu}); encode {t_enc * 1e3:.2f} ms (before the "
              f"host eigh {ms_before:.2f}), of which the host eigh {1e3 * sum(t for t, _ in eighs):.2f} ms over "
              f"{len(eighs)} Grams of n {sorted({n for _, n in eighs})}; decode {t_dec * 1e3:.2f} ms; card - CPU PSNR "
              f"{d_raw:+.4f} dB (before the host eigh {gap_before:+.4f})", flush=True)
        print(f"{name} [{label}] {kw}: PSNR {p_cpu + d_raw:.4f} dB on the card, {p_cpu:.4f} on the CPU; with the CPU's "
              f"signs {d_al:+.6f} dB; decoded debiased {d_unb:+.6f} dB; reconstruction within {gap:.3g} of the "
              f"CPU's (relative), factors' least |cos| {cos:.6f}{rank_note}", flush=True)
        if name == "hosvd":
            xf = mhosvd._to_unit_float(torch.from_numpy(img))
            (_, f_card), (_, f_cpu) = (mhosvd.hosvd(xf.to(d), rank=tuple(ranks_cpu)) for d in ("cuda", "cpu"))
            modes = []
            for a, b in zip(f_card, f_cpu):
                sign, least = column_signs(torch, a, b)
                modes.append(f"{tuple(a.shape)}: {int((sign < 0).sum())} columns re-signed, least |cos| {least:.6f}")
            print(f"{name} [{label}] {kw}: mode factors, card against CPU: {'; '.join(modes)}", flush=True)
        check(gap < 1e-3, f"{name} {kw}: card reconstruction off the CPU's by {gap} (relative)")
        check(abs(d_al) < 0.1, f"{name} {kw}: with the CPU's signs the card's PSNR is off the CPU's by {d_al} dB")
        check(abs(d_raw) < HOSVD_GAP_DB, f"{name} {kw}: the card's own PSNR is off the CPU's by {d_raw} dB")

    def tt_error(x):
        rec = lt.contract_tt(lt.ttd(x, (3, 48)))
        return float(torch.linalg.vector_norm(rec - x) / torch.linalg.vector_norm(x))

    x = torch.from_numpy(img.astype(np.float32) / 255.0)
    xc = x.cuda()
    err_card, err_cpu = tt_error(xc), tt_error(x)
    tt_ms = cuda_ms(lambda: lt.contract_tt(lt.ttd(xc, (3, 48))), 3)
    check(abs(err_card - err_cpu) < 1e-4, f"tt: relative error {err_card} on the card, {err_cpu} on the CPU")
    print(f"tt [{label}] (3, 512, 768) at ranks (3, 48): relative error {err_card:.7f} on the card, "
          f"{err_cpu:.7f} on the CPU; ttd + contract_tt {tt_ms:.3f} device ms", flush=True)


def phase_modules(torch, lt, bk, img: np.ndarray, label: str) -> None:
    """Phase 11, the module classes: `QMF.decompose` and `qmf_decompose_cuda`
    on one image's Y stack run the kernel `qmf_decompose` runs, once each,
    with the same bits; `QMF(verbose=True)` runs it once per sweep (10), with
    the same bits; `HOSVD` and `SVDInit` run."""
    import io
    from lrf_tpu_torch.ops import bcd as bcd_mod
    from lrf_tpu_torch.ops import color, pad, patch

    x = torch.from_numpy(img).cuda()
    y = patch.patchify(pad.pad_image(color.rgb_to_ycbcr(x)[0:1], (8, 8)), (8, 8))[None].contiguous()
    check(tuple(y.shape) == (1, 6144, 64), f"Y stack {tuple(y.shape)}")
    want = bcd_mod.qmf_decompose(y, 6, bounds=BOUNDS)
    printed = io.StringIO()
    for name, fn, sweeps in (
        ("QMF.decompose", lambda: lt.QMF(rank=6, bounds=BOUNDS).decompose(y), 1),
        ("qmf_decompose_cuda", lambda: lt.qmf_decompose_cuda(y, 6, bounds=BOUNDS), 1),
        ("QMF(verbose=True).decompose", lambda: lt.QMF(rank=6, bounds=BOUNDS, verbose=True).decompose(y), 10),
    ):
        for k in bk.KERNEL.counts:
            bk.KERNEL.counts[k] = 0
        with contextlib.redirect_stdout(printed):
            got = fn()
        launches = dict(bk.KERNEL.counts)
        check(launches == only(bk, bcd_cluster=sweeps), f"{name}: launched {launches}, expected bcd_cluster {sweeps}x")
        check(all(torch.equal(a, b) for a, b in zip(got, want)), f"{name} differs from qmf_decompose")
    check(printed.getvalue().count("loss =") == 10, f"QMF(verbose=True) printed {printed.getvalue()!r}")
    init = lt.SVDInit(rank=6, bounds=BOUNDS)(y)
    check(all(torch.equal(a, b) for a, b in zip(init, bcd_mod.svd_init(y, 6, bounds=BOUNDS))), "SVDInit != svd_init")
    xf = x.to(torch.float32) / 255.0
    rec = lt.HOSVD(rank=(3, 64, 64))(xf)
    rel = float(torch.linalg.vector_norm(rec - xf) / torch.linalg.vector_norm(xf))
    check(tuple(rec.shape) == tuple(xf.shape) and 0 < rel < 0.5, f"HOSVD: {tuple(rec.shape)}, relative error {rel}")
    print(f"modules [{label}]: QMF(rank=6).decompose and qmf_decompose_cuda on Y (1, 6144, 64): one bcd_cluster "
          f"launch each, QMF(verbose=True) one per sweep (10), bits equal to qmf_decompose; SVDInit equal to "
          f"svd_init; HOSVD (3, 64, 64) relative error "
          f"{rel:.6f}", flush=True)


def phase_jacobi(torch, lt, seed: int, images: np.ndarray, label: str) -> None:
    """Phase 11, the Jacobi eigensolver on the 192 bench Grams (Y of 64
    images, then their Cb and Cr) against `torch.linalg.eigh`: eigenvalues,
    leading eigenvectors, device ms (CUDA events) and device kernels
    launched (`torch.profiler`); then per-image PSNR of Jacobi-init encodes
    against the default at q10 and q40 on 8 images. Each Gram's eigenvalues
    must agree within 1e-4 of its largest, and Jacobi's 6 leading pairs be
    eigenpairs to that precision (near-equal eigenvalues make single
    eigenvectors ill-posed, so their |cos| against eigh's is printed, not
    held)."""
    from lrf_tpu_torch.ops import color, pad, patch, resample, svd
    from lrf_tpu_torch.ops.jacobi import jacobi_eigh

    x = torch.from_numpy(load_images(seed)).cuda()
    stacks = [patch.patchify(pad.pad_image(c, (8, 8)), (8, 8))
              for c in resample.chroma_downsample(color.rgb_to_ycbcr(x), (0.5, 0.5))]
    g = torch.cat([svd.gram(s) for s in (stacks[0], torch.cat(stacks[1:], dim=0))], dim=0)
    check(tuple(g.shape) == (192, 64, 64), f"Grams {tuple(g.shape)}")
    ev_l, vec_l = torch.linalg.eigh(g)
    ev_j, vec_j = jacobi_eigh(g)
    top = ev_l.abs().amax(dim=-1)  # per Gram
    ev_err = float(((ev_j - ev_l).abs().amax(dim=-1) / top).max())

    def residual(vec, ev):  # of the 6 leading pairs (the q10 Y rank), per Gram, over its largest eigenvalue
        v, e = vec[..., -6:], ev[..., -6:]
        return float((torch.linalg.vector_norm(g @ v - v * e[..., None, :], dim=-2).amax(dim=-1) / top).max())

    res_j, res_l = residual(vec_j, ev_j), residual(vec_l, ev_l)
    cos = (vec_j[..., -6:] * vec_l[..., -6:]).sum(-2).abs()
    check(ev_err < 1e-4, f"jacobi eigenvalues off eigh's by {ev_err} of the largest")
    check(res_j < 1e-4, f"jacobi's leading pairs are not eigenpairs: residual {res_j} of the largest eigenvalue")
    jac_ms = cuda_ms(lambda: jacobi_eigh(g), 3)
    eigh_ms = cuda_ms(lambda: torch.linalg.eigh(g), 3)
    jac_k = device_kernels(torch, lambda: jacobi_eigh(g))
    eigh_k = device_kernels(torch, lambda: torch.linalg.eigh(g))
    print(f"jacobi [{label}]: 192 bench Grams 64x64: eigenvalues within {ev_err:.3g} of each Gram's largest of "
          f"eigh's; leading 6 pairs' residual {res_j:.3g} (eigh {res_l:.3g}), eigenvectors' |cos| against eigh's "
          f">= {float(cos.min()):.7f}; jacobi_eigh {jac_ms:.3f} device ms, "
          f"{len(jac_k)} device kernels; torch.linalg.eigh {eigh_ms:.3f} device ms, {len(eigh_k)} device kernels",
          flush=True)
    for q in (10, 40):
        d = []
        for img in images:
            p_def = float(per_image_psnr(img, lt.qmf_decode(lt.qmf_encode(img, quality=q, device="cuda"), device="cuda")))
            s_jac = lt.qmf_encode(img, quality=q, device="cuda", init_method="jacobi")
            p_jac = float(per_image_psnr(img, lt.qmf_decode(s_jac, device="cuda")))
            check(np.isfinite(p_jac) and p_jac > 15, f"jacobi-init q{q} PSNR {p_jac}")
            d.append(p_jac - p_def)
        print(f"jacobi [{label}] q{q}: Jacobi-init encode PSNR - default PSNR over 8 x 512x768: mean {np.mean(d):+.4f} "
              f"dB, min {min(d):+.4f}, max {max(d):+.4f}", flush=True)


def phase_secondary(torch, lt, bk, seed: int, label: str) -> None:
    """Phase 11: the CLI, the SVD and HOSVD codecs, TT, the module classes
    and the Jacobi eigensolver at the bench image size."""
    import tempfile

    images = load_images(seed, count=8)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(torch, lt, bk, images[0], label, tmp)
    phase_svd_codec(torch, lt, images, label)
    phase_hosvd_tt(torch, lt, images[1], label)
    phase_modules(torch, lt, bk, images[0], label)
    phase_jacobi(torch, lt, seed, images, label)


# Phase 12: the sweep layer. The comparison grid, cut to every 4th QMF
# quality of linspace(0, 40, 80), every 3rd SVD quality of linspace(0, 5,
# 30) and every 5th JPEG quality of 0-74; the qualities of the CPU
# cross-check and the ablations: the full grid's 5.06, 20.25 and 40.
SWEEP_QMF_Q = np.linspace(0, 40, 80)[::4]
SWEEP_SVD_Q = np.linspace(0.0, 5, 30)[::3]
SWEEP_JPEG_Q = range(0, 75, 5)
CHECK_Q = np.linspace(0, 40, 80)[[10, 40, 79]]
CHECK_SVD_Q = float(np.linspace(0.0, 5, 30)[10])
CHECK_JPEG_Q = 30
# Card and CPU QMF streams from each side's own init: held to the port's RD
# contract, PSNR within 0.2 dB, with bpp within CHECK_BPP and SSIM within
# CHECK_SSIM, and to the one-init check's rule: at most
# ONE_INIT_STREAMS_APART streams apart, each parting at round() ties. The
# first bounds of 1% and 1e-3 were once widened to 2% and 5e-3 after they
# failed on an H100 (700 W; china.png q20.25 SSIM 1.13e-3 apart,
# clic_flower_fig.png q40 1.24% bpp): the two inits differed. With the
# card's X the CPU's (the chroma pool's fixed tap order) the gap stayed
# (clic_flower_fig.png q40 1.1540% bpp, 0.068512 dB, SSIM 1.70e-3): what
# still differed was the init's Gram (cuBLAS against the CPU's BLAS), its
# eigensolver (cuSOLVER against LAPACK) and its square roots (torch's CPU
# float32 sqrt is not always correctly rounded). The exact init now forms
# its Gram in float64 rounded once, takes the host's LAPACK eigh on every
# device and rounds its roots from float64, so each side's own init is
# the other's (`sweep_init` holds that) and the first bounds are back
# (read: within 0.0204% bpp and SSIM 3.61e-05; H100, 700 W).
CHECK_BPP = 0.01
CHECK_SSIM = 1e-3
# The cause those bounds rest on, measured: the same points from one X and
# one init (the CPU's). Predicted from the kernels' agreement with the plain
# version from one init (99.79-100% of entries, 60-62 of 64 bench streams
# byte-identical): at most this many of the 6 streams apart, and each stack
# that parts parting first at round() ties of the two sides' float32 sums:
# every entry of the first column apart within TIE_DIST of x.5 in float64.
# The first bound, at least 99.79% of each point's entries equal, failed on
# an H100 (700 W): china.png q20.25 read 97.40% (its Cr stack (1, 1080, 64)
# at R 6, the kernel 1 V entry apart at sweep 6, the card's plain version
# equal to the CPU's, then 76 U and 10 V entries after 10 sweeps) at
# +0.000462 dB and -0.0204% bpp, against 0.043 dB and 1.24% from each
# side's own init; 5 of 6 streams byte-identical. The share is printed.
ONE_INIT_STREAMS_APART = 1
TIE_DIST = 1e-4
RGB_Q = np.linspace(0.0, 10, 50)[[10, 25, 49]]
ABLATION_IMAGE = "parrots_recon_a.png"  # 768x512
# (ablation, label, sweep_qmf overrides); the color-space ablation's RGB
# configuration is `drivers.rgb_qmf_params`
ABLATIONS = (
    [("bounds", f"bounds {b}", {"bounds": b}) for b in [(-8, 7), (-16, 15), (-32, 31), (-128, 127)]]
    + [("numiters", f"num_iters {k}", {"num_iters": k}) for k in [0, 1, 2, 5, 10]]
    + [("patchsize", f"patch {p}x{p}", {"patch": True, "patch_size": (p, p)}) for p in (4, 8, 16, 32)]
    + [("patchsize", "no patch", {"patch": False, "patch_size": None})]
)
# The ablation configs whose shapes are new to bcd_grid: held against an
# encode whose BCD is the plain version, and their stacks timed.
NEW_SHAPES = ("patch 4x4", "patch 16x16", "patch 32x32", "no patch")
METRIC_KEYS = ("compression ratio", "bit rate (bpp)", "PSNR (dB)", "SSIM", "encoding time (ms)", "decoding time (ms)")


def codec_stacks(torch, img: np.ndarray, params: dict) -> list:
    """`(X (B, M, N) float32 on the card, R)` of each BCD launch that
    `qmf_encode(img, **params)` makes, as it builds them."""
    from lrf_tpu_torch.models.qmf import _channel_ranks, _rank_from_quality
    from lrf_tpu_torch.ops import color, pad, patch, resample

    x = torch.from_numpy(np.ascontiguousarray(img)).cuda()
    size = tuple(img.shape[-2:])
    ps = tuple(params["patch_size"]) if params["patch"] else (8, 8)
    if params["color_space"] == "RGB":
        xf = x.to(torch.float32)
        xm = patch.patchify(pad.pad_image(xf, ps), ps)[None] if params["patch"] else xf
        return [(xm.contiguous(), _rank_from_quality(tuple(xm.shape[-2:]), params["quality"]))]
    channels = resample.chroma_downsample(color.rgb_to_ycbcr(x), tuple(params["scale_factor"]))
    chroma = resample.scaled_size(size, tuple(params["scale_factor"]))
    ranks = _channel_ranks((size, chroma, chroma), None, params["quality"], params["patch"], ps)
    out = []
    for c, r in zip(channels, ranks):
        xm = patch.patchify(pad.pad_image(c, ps), ps)[None] if params["patch"] else c
        out.append((xm.to(torch.float32).contiguous(), r))
    return out


def planned_launches(bk, stacks, num_iters: int) -> dict:
    want = only(bk)
    if num_iters > 0:
        for xm, r in stacks:
            want[bk.KERNEL.plan(xm.shape[1], xm.shape[2], r).variant] += 1
    return want


def reset_counts(bk) -> None:
    for name in bk.KERNEL.counts:
        bk.KERNEL.counts[name] = 0


@contextlib.contextmanager
def plain_bcd(bk):
    """Within the block, the BCD wrapper runs the plain version on the card."""
    fn = bk.bcd
    bk.bcd = lambda x, u0, v0, num_iters=10, bounds=(-16, 15): bk.bcd_reference(x, u0, v0, num_iters, bounds)
    try:
        yield
    finally:
        bk.bcd = fn


@contextlib.contextmanager
def one_init(torch, bcd_mod, mod, record: list, stacks=None):
    """Within the block, `mod.qmf_decompose` (the codec's or the entry's BCD)
    starts every stack from the CPU's init: `svd_init` of the stack on the
    CPU, moved to the stack's device, then `bcd_from_init` there (the planned
    kernel on the card, the plain sweeps on the CPU). Each call's `(X, u, v)`
    goes to `record`. Given `stacks` (an earlier run's record), call i sweeps
    `stacks[i]`'s X instead of its own, so that both runs see one X and one
    init; the share of its own X's entries equal to that one goes to
    `record` too, as a fourth item."""
    fn = mod.qmf_decompose

    def wrapped(xm, rank, num_iters=10, bounds=(None, None), factor=(0, 1), **kw):
        x = xm.to(torch.float32)
        x_equal = None
        if stacks is not None:
            given = stacks[len(record)][0].to(x.device)
            x_equal = float((given == x).float().mean()) if given.shape == x.shape else 0.0
            x = given
        init = tuple(t.to(x.device) for t in bcd_mod.svd_init(x.cpu(), rank, bounds=bounds))
        u, v, w = bcd_mod.bcd_from_init(x, init, num_iters=num_iters, bounds=bounds, factor=factor, **kw)
        record.append((x, u, v, x_equal))
        return u, v, w

    mod.qmf_decompose = wrapped
    try:
        yield
    finally:
        mod.qmf_decompose = fn


def equal_share(torch, a, b) -> float:
    return float((a.cpu() == b.cpu()).float().mean())


def gs_pre_round(torch, xw, other, prev, new):
    """float64 values before rounding of one Gauss-Seidel pass of the
    plain sweeps (`ops/bcd.py::update_columns`, no l1 or l2) that took the
    factor from `prev` to `new`, with `other` the fixed factor and `xw` the
    normalised X whose rows the factor's rows follow."""
    a = torch.matmul(xw, other)
    b = torch.matmul(other.transpose(-1, -2), other)
    pre = torch.empty_like(prev)
    for r in range(prev.shape[-1]):
        mix = torch.cat([new[..., :r], prev[..., r:]], dim=-1)
        term2 = torch.matmul(mix, b[..., :, r : r + 1]) - prev[..., r : r + 1] * b[..., r : r + 1, r : r + 1]
        pre[..., r : r + 1] = (a[..., r : r + 1] - term2 + 1e-16) / (b[..., r : r + 1, r : r + 1] + 1e-16)
    return pre


def first_parting(torch, bcd_mod, x, r: int):
    """Where the planned kernel on the card and the plain sweeps on the CPU
    part, both from the CPU's init of `x`: `(sweep, factor, entries apart in
    the first column apart, the largest distance of those entries' float64
    values before rounding from a rounding tie x.5)`, or None where they
    never part in ITERS sweeps. Within a phase the first column apart holds
    where they part; later columns and sweeps carry it on."""
    x_cpu = x.cpu()
    init = bcd_mod.svd_init(x_cpu, r, bounds=BOUNDS)
    init_dev = tuple(t.to(x.device) for t in init)
    w = init[2]
    xw = ((x_cpu - w[..., 0:1, :]) / w[..., 1:2, :]).double()
    return parting(torch, xw, init[:2],
                   lambda k: [t.cpu() for t in bcd_mod.bcd_from_init(x, init_dev, num_iters=k, bounds=BOUNDS)[:2]],
                   lambda k: bcd_mod.bcd_from_init(x_cpu, init, num_iters=k, bounds=BOUNDS)[:2])


def parting(torch, xw, init, run, plain):
    """Where `run(k)` and `plain(k)`, the factors `(u, v)` on the host after
    k sweeps from `init` (the plain sweeps for `plain`), first part, with
    `xw` the normalised X in float64: `(sweep, factor, entries apart in the
    first column apart, the largest distance of those entries' float64
    values before rounding from a rounding tie x.5)`, or None."""
    prev = tuple(t.cpu() for t in init)
    for k in range(1, ITERS + 1):
        got_k, want_k = run(k), plain(k)
        # U is updated first; V's pass of sweep k sees this sweep's U
        passes = ((xw, prev[1], prev[0]), (xw.transpose(-1, -2), want_k[0], prev[1]))
        for f, ((xs, other, before), got, want) in enumerate(zip(passes, got_k, want_k)):
            apart = got != want
            if bool(apart.any()):
                pre = gs_pre_round(torch, xs, other.double(), before.double(), want.double())
                col = int(apart.reshape(-1, apart.shape[-1]).any(0).nonzero()[0])
                mask = apart[..., col]
                dist = (pre[..., col][mask] - torch.floor(pre[..., col][mask]) - 0.5).abs()
                return k, "UV"[f], int(mask.sum()), float(dist.max())
        prev = want_k
    return None


def jax_row_keys() -> dict:
    """Per method, the key order of the JAX package's stored sweep rows."""
    with open(os.path.join(HERE, "experiments", "comparison", "local7_results.json")) as f:
        rows = json.load(f)
    return {m: list(next(r for r in rows if r["method"] == m)) for m in ("JPEG", "SVD", "QMF")}


def sweep_comparison(torch, lt, bk, label: str, tmp: str):
    """The comparison sweep over the local7 images through
    `run_over_dataset`: first over the first 3 images, then over all 7 into
    the same file (which must sweep only the other 4 and leave the first 3
    images' rows as they were); every QMF encode launches what its stacks
    plan. Returns the rows and the per-method sweep seconds."""
    from lrf_tpu_torch.experiments import common as ex
    from lrf_tpu_torch.utils.config import read_config

    local7 = os.path.join(HERE, "experiments", "data", "local7")
    paths = ex.dataset_images(local7)
    check(len(paths) == 7, f"local7 holds {len(paths)} PNGs, expected 7")
    first3 = os.path.join(tmp, "first3")
    os.makedirs(first3)
    for p in paths[:3]:
        os.symlink(p, os.path.join(first3, os.path.basename(p)))
    seconds = collections.defaultdict(float)
    launches = collections.Counter()
    swept = []

    def per_image(image, image_id):
        swept.append(image_id)
        t0 = time.perf_counter()
        rows = ex.sweep_jpeg(image, image_id, qualities=SWEEP_JPEG_Q, device="cuda")
        t1 = time.perf_counter()
        rows += ex.sweep_svd(image, image_id, qualities=SWEEP_SVD_Q, device="cuda")
        t2 = time.perf_counter()
        for q in SWEEP_QMF_Q:
            params = ex.qmf_params(q)
            want = planned_launches(bk, codec_stacks(torch, image, params), params["num_iters"])
            reset_counts(bk)
            rows += ex.sweep_qmf(image, image_id, qualities=[q], device="cuda")
            got = dict(bk.KERNEL.counts)
            check(got == want, f"sweep {image_id} QMF q{q:.2f}: launched {got}, its stacks plan {want}")
            launches.update(got)
        t3 = time.perf_counter()
        for method, t in (("JPEG", t1 - t0), ("SVD", t2 - t1), ("QMF", t3 - t2)):
            seconds[method] += t
        return rows

    out = os.path.join(tmp, "results")
    ex.run_over_dataset(first3, per_image, out, "local7", verbose=False)
    before = read_config(os.path.join(out, "local7_results.json"))
    check(swept == [os.path.basename(p) for p in paths[:3]], f"first run swept {swept}")
    rows = ex.run_over_dataset(local7, per_image, out, "local7", verbose=False)
    check(swept[3:] == [os.path.basename(p) for p in paths[3:]], f"the resumed run swept {swept[3:]}")
    check(rows[: len(before)] == before, "the resumed run changed the first 3 images' rows")
    stored = read_config(os.path.join(out, "local7_results.json"))
    check([r["data"] for r in stored] == [r["data"] for r in rows], "the results file does not hold the rows returned")
    keys = jax_row_keys()
    for row in rows:
        want = keys[row["method"]] + ["encoding device time (ms)"]
        check(list(row) == want, f"{row['data']} {row['method']}: row keys {list(row)}, the JAX schema {want}")
        check(np.isfinite(row["PSNR (dB)"]) and row["platform"].startswith("cuda"), f"row {row}")
    per = len(SWEEP_JPEG_Q) + len(SWEEP_SVD_Q) + len(SWEEP_QMF_Q)
    check(len(rows) == 7 * per, f"{len(rows)} rows, expected {7 * per}")
    print(f"sweeps [{label}] comparison over the 7 local7 images ({per} points each: JPEG {len(SWEEP_JPEG_Q)}, SVD "
          f"{len(SWEEP_SVD_Q)}, QMF {len(SWEEP_QMF_Q)}): {len(rows)} rows of the JAX schema (plus the device "
          f"time); run over the first 3, then resumed over all 7: swept the other 4 only, the first 3 images' rows "
          f"unchanged; QMF launches {dict(launches)}, each encode the kernels its stacks plan; sweep seconds "
          f"{', '.join(f'{m} {t:.2f}' for m, t in seconds.items())} ({len(rows) / sum(seconds.values()):.2f} rows/s)",
          flush=True)
    return rows, dict(seconds)


def front_end_stacks(torch, img: np.ndarray, device: str) -> list:
    """The codec's Y, Cb and Cr patch stacks of `img` (YCbCr, chroma at 0.5,
    8x8 patches) built on `device`, on the host."""
    from lrf_tpu_torch.ops import color, pad, patch, resample

    x = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    return [patch.patchify(pad.pad_image(c, (8, 8)), (8, 8)).cpu()
            for c in resample.chroma_downsample(color.rgb_to_ycbcr(x), (0.5, 0.5))]


def sweep_front_end(torch, lt, label: str) -> None:
    """The card's X against the CPU's on each local7 image: the Y, Cb and
    Cr stacks built on the card and on the CPU must have no entry apart
    (the chroma pool sums in one fixed order on every device)."""
    from lrf_tpu_torch.experiments import common as ex

    for path in ex.dataset_images(os.path.join(HERE, "experiments", "data", "local7")):
        img, name = lt.read_image(path), os.path.basename(path)
        apart = []
        for card, cpu in zip(front_end_stacks(torch, img, "cuda"), front_end_stacks(torch, img, "cpu")):
            check(card.shape == cpu.shape, f"{name}: stack {tuple(card.shape)} on the card, {tuple(cpu.shape)} on the CPU")
            apart.append((int((card != cpu).sum()), card.numel()))
        print(f"sweeps [{label}] {name} {tuple(img.shape)}: the card's X against the CPU's, entries apart: "
              + ", ".join(f"{c} {n} of {m}" for c, (n, m) in zip(("Y", "Cb", "Cr"), apart)), flush=True)
        check(all(n == 0 for n, _ in apart), f"{name}: the card's X differs from the CPU's: {apart}")


# Where the card's and the CPU's exact-init Grams or inits may part: a Gram
# entry whose float64 sum lies within GRAM_TIE (relative) of the midpoint of
# the two float32 values, and a rank component negated whole where the two
# orientations' clip penalties tie within SIGN_TIE (relative).
GRAM_TIE = 1e-12
SIGN_TIE = 1e-4


def gram_parting(torch, svd, x_card, x_cpu) -> tuple:
    """`(share of the Gram's entries equal card against CPU, entries apart,
    the largest relative distance of those entries' float64 sums from the
    midpoint of the two float32 values)` of the exact init's Gram."""
    g_card, g_cpu = svd.exact_gram(x_card).cpu(), svd.exact_gram(x_cpu)
    apart = g_card != g_cpu
    dist = 0.0
    if bool(apart.any()):
        g64 = svd.gram64(x_cpu)[apart]
        mid = (g_card[apart].double() + g_cpu[apart].double()) / 2
        dist = float(((g64 - mid).abs() / g64.abs().clamp(min=1e-300)).max())
    return equal_share(torch, g_card, g_cpu), int(apart.sum()), dist


def init_parting(torch, bcd_mod, card, cpu) -> list:
    """The rank components in which the card's init `(u, v)` differs from
    the CPU's: `(k, negated whole, relative gap of the CPU's two clip
    penalties)` each."""
    out = []
    for k in range(cpu[0].shape[-1]):
        uc, vc, up, vp = card[0][..., k].cpu(), card[1][..., k].cpu(), cpu[0][..., k], cpu[1][..., k]
        if torch.equal(uc, up) and torch.equal(vc, vp):
            continue
        pos = float(bcd_mod.clip_penalty(up[..., None], BOUNDS).sum() + bcd_mod.clip_penalty(vp[..., None], BOUNDS).sum())
        neg = float(bcd_mod.clip_penalty(-up[..., None], BOUNDS).sum()
                    + bcd_mod.clip_penalty(-vp[..., None], BOUNDS).sum())
        out.append((k, torch.equal(uc, -up) and torch.equal(vc, -vp), abs(pos - neg) / max(pos, neg, 1e-30)))
    return out


def sweep_init(torch, lt, label: str) -> None:
    """The exact init on the card against the CPU's on each local7 image:
    each Y, Cb and Cr stack's Gram (`ops/svd.py::exact_gram`, float64 sums
    rounded once) and its init's U and V at CHECK_Q. The Grams must be equal
    but for entries at GRAM_TIE of a rounding midpoint, and where a stack's
    Grams are equal its inits must be equal but for whole components
    negated at SIGN_TIE (the eigh is the host's LAPACK on both sides); the
    equal shares are printed."""
    from lrf_tpu_torch.experiments import common as ex
    from lrf_tpu_torch.models.qmf import _channel_ranks
    from lrf_tpu_torch.ops import bcd as bcd_mod
    from lrf_tpu_torch.ops import resample, svd

    # The init's square roots are taken in float64 (`svd.rounded_sqrt`):
    # torch's float32 sqrt on each device against that, on seeded values.
    gen = torch.Generator().manual_seed(0)
    vals = torch.rand(1 << 16, generator=gen) * torch.exp2(torch.randint(-30, 40, (1 << 16,), generator=gen).float())
    want = svd.rounded_sqrt(vals)
    print(f"sweeps [{label}] torch.sqrt in float32 against the correctly rounded root on {len(vals)} values: "
          f"{int((torch.sqrt(vals.cuda()).cpu() != want).sum())} apart on the card, "
          f"{int((torch.sqrt(vals) != want).sum())} on the CPU", flush=True)
    failed, shares = [], collections.defaultdict(list)
    for path in ex.dataset_images(os.path.join(HERE, "experiments", "data", "local7")):
        img, name = lt.read_image(path), os.path.basename(path)
        size = tuple(img.shape[-2:])
        chroma = resample.scaled_size(size, (0.5, 0.5))
        stacks = list(zip(("Y", "Cb", "Cr"), front_end_stacks(torch, img, "cuda"), front_end_stacks(torch, img, "cpu")))
        line = []
        for c, (what, x_card, x_cpu) in enumerate(stacks):
            x_card = x_card.cuda()
            share, apart, dist = gram_parting(torch, svd, x_card, x_cpu)
            shares["gram"].append(share)
            line.append(f"{what} Gram {share:.6f}" + (f" ({apart} apart, within {dist:.3g} of a tie)" if apart else ""))
            if apart and dist >= GRAM_TIE:
                failed.append(f"{name} {what} Gram: {apart} entries apart, {dist:.3g} from a tie")
            for q in CHECK_Q:
                r = _channel_ranks((size, chroma, chroma), None, q, True, (8, 8))[c]
                card = bcd_mod.svd_init(x_card, r, bounds=BOUNDS)
                cpu = bcd_mod.svd_init(x_cpu, r, bounds=BOUNDS)
                u_eq, v_eq = equal_share(torch, card[0], cpu[0]), equal_share(torch, card[1], cpu[1])
                shares["u"].append(u_eq)
                shares["v"].append(v_eq)
                parting = init_parting(torch, bcd_mod, card, cpu)
                line.append(f"q{q:.2f} R {r} U {u_eq:.6f} V {v_eq:.6f}"
                            + (f" apart in components {parting}" if parting else ""))
                if not apart and not all(neg and gap < SIGN_TIE for _, neg, gap in parting):
                    failed.append(f"{name} {what} q{q:.2f}: init apart in {parting}")
        print(f"sweeps [{label}] {name}: the exact init on the card against the CPU's, equal shares: "
              + "; ".join(line), flush=True)
    print(f"sweeps [{label}] exact init card against CPU over the 7 local7 images x Y, Cb, Cr: Grams equal "
          f"{min(shares['gram']):.6f}-{max(shares['gram']):.6f}, at q {', '.join(f'{q:.2f}' for q in CHECK_Q)} "
          f"U equal {min(shares['u']):.6f}-{max(shares['u']):.6f}, V equal {min(shares['v']):.6f}-"
          f"{max(shares['v']):.6f}", flush=True)
    check(not failed, f"the exact init on the card parts from the CPU's: {failed}")


@contextlib.contextmanager
def recorded(mod, record: list):
    """Within the block, each call of `mod.qmf_decompose` appends its `(X,
    u, v)` to `record`."""
    fn = mod.qmf_decompose

    def wrapped(xm, *args, **kw):
        u, v, w = fn(xm, *args, **kw)
        record.append((xm, u, v))
        return u, v, w

    mod.qmf_decompose = wrapped
    try:
        yield
    finally:
        mod.qmf_decompose = fn


def own_init_partings(torch, bcd_mod, rec_card, rec_cpu, what: str) -> list:
    """Each stack whose factors part, card against CPU, each side from its
    own init: `(stack, first_parting(...))`."""
    out = []
    for a, b in zip(rec_card, rec_cpu):
        if not (torch.equal(a[1].cpu(), b[1]) and torch.equal(a[2].cpu(), b[2])):
            out.append((f"{what} {tuple(a[0].shape)} R {a[1].shape[-1]}",
                        first_parting(torch, bcd_mod, a[0].to(torch.float32), a[1].shape[-1])))
    return out


def sweep_cpu_check(torch, lt, bk, label: str) -> None:
    """The port on the same machine's CPU against the card on 2 local7
    images: QMF at 3 qualities (PSNR within 0.2 dB, bpp within CHECK_BPP,
    SSIM within CHECK_SSIM; from each side's own init at most
    ONE_INIT_STREAMS_APART streams not byte-identical, each stack whose
    factors part doing so first at round() ties), one JPEG point (equal
    bytes, metrics within 1e-5) and one SVD point (PSNR within SVD_GAP_DB).
    Then the cause those QMF bounds rest on: each QMF point encoded again on
    both sides from one X and one init (`one_init`), where the card's sweeps
    must agree with the CPU's as the kernels agree with the plain version:
    at most ONE_INIT_STREAMS_APART streams not byte-identical, and each
    stack whose factors part doing so first at round() ties
    (`first_parting` within TIE_DIST); the equal shares, PSNR and bpp gaps
    are printed."""
    from lrf_tpu_torch.experiments import common as ex
    from lrf_tpu_torch.models import qmf as mq
    from lrf_tpu_torch.ops import bcd as bcd_mod

    paths = ex.dataset_images(os.path.join(HERE, "experiments", "data", "local7"))[:2]
    worst = collections.defaultdict(float)
    failed = []
    one, own = collections.defaultdict(list), collections.defaultdict(list)
    t0 = time.perf_counter()
    for path in paths:
        img, name = lt.read_image(path), os.path.basename(path)
        card = ex.sweep_qmf(img, name, qualities=CHECK_Q, device="cuda")
        cpu = ex.sweep_qmf(img, name, qualities=CHECK_Q, device="cpu")
        for q in CHECK_Q:
            params, rec_card, rec_cpu = ex.qmf_params(q), [], []
            with recorded(mq, rec_card):
                s_card = lt.qmf_encode(img, device="cuda", **params)
            with recorded(mq, rec_cpu):
                s_cpu = lt.qmf_encode(img, device="cpu", **params)
            own["same"].append(s_card == s_cpu)
            own["parting"] += own_init_partings(torch, bcd_mod, rec_card, rec_cpu, f"{name} q{q:.2f}")
            rec_card, rec_cpu = [], []
            with one_init(torch, bcd_mod, mq, rec_card):
                s_card = lt.qmf_encode(img, device="cuda", **params)
            with one_init(torch, bcd_mod, mq, rec_cpu, stacks=rec_card):
                s_cpu = lt.qmf_encode(img, device="cpu", **params)
            eq = min(min(equal_share(torch, a[1], b[1]), equal_share(torch, a[2], b[2]))
                     for a, b in zip(rec_card, rec_cpu))
            for a, b in zip(rec_card, rec_cpu):
                if not (torch.equal(a[1].cpu(), b[1]) and torch.equal(a[2].cpu(), b[2])):
                    one["parting"].append((f"{name} q{q:.2f} {tuple(a[0].shape)} R {a[1].shape[-1]}",
                                           first_parting(torch, bcd_mod, a[0], a[1].shape[-1])))
            p_card, p_cpu = (float(lt.psnr(img, lt.qmf_decode(st, device="cpu"))) for st in (s_card, s_cpu))
            one["equal"].append(eq)
            one["same"].append(s_card == s_cpu)
            one["psnr"].append(p_card - p_cpu)
            one["bpp"].append(len(s_card) / len(s_cpu) - 1)
            one["x"].append(min(r[3] for r in rec_cpu))
            print(f"sweeps [{label}] {name} QMF q{q:.2f} from one X and one init: factor entries equal "
                  f"{eq:.6f} (least of its {len(rec_card)} stacks), streams {'byte-identical' if s_card == s_cpu else 'apart'}"
                  f", card - CPU PSNR {p_card - p_cpu:+.6f} dB, bpp {100 * (len(s_card) / len(s_cpu) - 1):+.4f}%; the "
                  f"CPU's own X equal to the card's in {one['x'][-1]:.6f} of entries", flush=True)
        for a, b in zip(card, cpu):
            d_bpp = abs(a["bit rate (bpp)"] / b["bit rate (bpp)"] - 1)
            d_psnr, d_ssim = abs(a["PSNR (dB)"] - b["PSNR (dB)"]), abs(a["SSIM"] - b["SSIM"])
            point = (f"{name} QMF q{a['quality'][0]:.2f}: card {a['bit rate (bpp)']:.6f} bpp {a['PSNR (dB)']:.4f} dB "
                     f"SSIM {a['SSIM']:.6f}, CPU {b['bit rate (bpp)']:.6f} {b['PSNR (dB)']:.4f} {b['SSIM']:.6f}")
            print(f"sweeps [{label}] {point}", flush=True)
            if not (d_bpp < CHECK_BPP and d_psnr < 0.2 and d_ssim < CHECK_SSIM):
                failed.append(point)
            worst["QMF bpp"] = max(worst["QMF bpp"], d_bpp)
            worst["QMF PSNR"] = max(worst["QMF PSNR"], d_psnr)
            worst["QMF SSIM"] = max(worst["QMF SSIM"], d_ssim)
        (a,), (b,) = (ex.sweep_jpeg(img, name, qualities=[CHECK_JPEG_Q], device=d) for d in ("cuda", "cpu"))
        check(a["bit rate (bpp)"] == b["bit rate (bpp)"], f"{name} JPEG q{CHECK_JPEG_Q}: bytes differ")
        for key in ("PSNR (dB)", "SSIM"):
            check(abs(a[key] - b[key]) <= 1e-5 * abs(b[key]), f"{name} JPEG {key} {a[key]} vs {b[key]}")
        (a,), (b,) = (ex.sweep_svd(img, name, qualities=[CHECK_SVD_Q], device=d) for d in ("cuda", "cpu"))
        d = a["PSNR (dB)"] - b["PSNR (dB)"]
        check(abs(d) < SVD_GAP_DB, f"{name} SVD q{CHECK_SVD_Q:.2f}: card {d:+.6f} dB off the CPU")
        worst["SVD PSNR"] = max(worst["SVD PSNR"], abs(d))
        worst["SVD bpp"] = max(worst["SVD bpp"], abs(a["bit rate (bpp)"] / b["bit rate (bpp)"] - 1))
    print(f"sweeps [{label}] card against the CPU on {', '.join(os.path.basename(p) for p in paths)}: QMF at q "
          f"{', '.join(f'{q:.2f}' for q in CHECK_Q)}: bpp within {100 * worst['QMF bpp']:.4f}%, PSNR within "
          f"{worst['QMF PSNR']:.6f} dB, SSIM within {worst['QMF SSIM']:.2e}; JPEG q{CHECK_JPEG_Q} equal bytes; SVD "
          f"q{CHECK_SVD_Q:.2f}: card - CPU PSNR within {worst['SVD PSNR']:.6f} dB, bpp within "
          f"{100 * worst['SVD bpp']:.4f}%; {time.perf_counter() - t0:.1f} s", flush=True)
    apart = one["same"].count(False)
    print(f"sweeps [{label}] the same QMF points from one X and one init (the card's sweeps in the planned kernels, "
          f"the CPU's plain): factor entries equal {min(one['equal']):.6f}-{max(one['equal']):.6f}, "
          f"{len(one['same']) - apart} of {len(one['same'])} streams byte-identical, card - CPU PSNR "
          f"{min(one['psnr']):+.6f} to {max(one['psnr']):+.6f} dB, bpp {100 * min(one['bpp']):+.4f}% to "
          f"{100 * max(one['bpp']):+.4f}%; from each side's own init: bpp within {100 * worst['QMF bpp']:.4f}%, PSNR "
          f"within {worst['QMF PSNR']:.6f} dB", flush=True)
    own_apart = own["same"].count(False)
    print(f"sweeps [{label}] the same QMF points from each side's own init: {len(own['same']) - own_apart} of "
          f"{len(own['same'])} streams byte-identical", flush=True)
    for how, partings in (("own init", own["parting"]), ("one X and one init", one["parting"])):
        for stack, at in partings:
            print(f"sweeps [{label}] {how}: {stack}: the planned kernel parts from the CPU's plain sweeps "
                  + (f"at sweep {at[0]}, {at[1]} pass, {at[2]} entries of its first column apart, each within "
                     f"{at[3]:.3g} of a rounding tie" if at else "nowhere in a rerun (the two runs part elsewhere)"),
                  flush=True)
    check(not failed, f"QMF card against CPU beyond bpp {CHECK_BPP}, 0.2 dB or SSIM {CHECK_SSIM}: {failed}")
    check(own_apart <= ONE_INIT_STREAMS_APART and all(at and at[3] < TIE_DIST for _, at in own["parting"]),
          f"from each side's own init the card's QMF streams part from the CPU's: {own_apart} streams apart, "
          f"partings {own['parting']}")
    check(apart <= ONE_INIT_STREAMS_APART and all(at and at[3] < TIE_DIST for _, at in one["parting"]),
          f"from one X and one init the card's sweeps part from the CPU's: {apart} streams apart, partings "
          f"{one['parting']}")


def grid_stack_reading(torch, bk, bcd_mod, what: str, xm, r: int) -> dict:
    """`bcd_grid` at one real stack: on the stack over 16 rounded to integers,
    from the init projected to integers, bit-equal to the plain version wherever
    `gs_sum_bound` keeps every sum below 2**24 (`check_integer_init`); on
    the float stack its loss against the plain version's on the card (`ok`:
    within 2e-3) and its equal share, printed (at wide ranks the card's
    plain version, summing in cuBLAS's order, parts from it at round() ties
    in up to a fifth of the entries); its ms in turns with the plain
    version, the bound."""
    b, m, n = xm.shape
    xi = torch.round(xm / 16)  # 0-16: small enough that the sums at these widths stay exact
    ui, vi, _ = bcd_mod.svd_init(xi, r, bounds=BOUNDS)
    check_integer_init(torch, bk, f"{what} {(b, m, n, r)}, integer X", xi, ui, vi, BOUNDS)
    u0, v0, _ = bcd_mod.svd_init(xm, r, bounds=BOUNDS)
    uk, vk = run_variant(bk, xm, u0, v0, BOUNDS, "bcd_grid")
    ur, vr = bk.bcd_reference(xm, u0, v0, num_iters=ITERS, bounds=BOUNDS)
    eq = min(float((uk == ur).float().mean()), float((vk == vr).float().mean()))
    loss_k, loss_r = float(bcd_mod.qmf_loss(xm, uk, vk).mean()), float(bcd_mod.qmf_loss(xm, ur, vr).mean())
    ms = [cuda_ms(lambda: run_variant(bk, xm, u0, v0, BOUNDS, "bcd_grid"), 10)]
    plain_ms = cuda_ms(lambda: bk.bcd_reference(xm, u0, v0, num_iters=ITERS), 1)
    ms.append(cuda_ms(lambda: run_variant(bk, xm, u0, v0, BOUNDS, "bcd_grid"), 10))
    bound, by = bcd_bound_ms(b, m, n, r, ITERS)
    plan = bk.KERNEL.plan(m, n, r)
    return dict(shape=(b, m, n, r), ms=sum(ms) / 2, plain_ms=plain_ms, bound_ms=bound, bound_by=by, eq=eq,
                loss=(loss_k, loss_r), ok=abs(loss_k - loss_r) < 2e-3, where=f"{plan.cluster} CTAs of {plan.tile} rows")


def sweep_ablations(torch, lt, bk, label: str) -> dict:
    """The four ablations on one 768x512 local7 image at three qualities:
    every config's launches against its stacks' plan; with num_iters = 0
    no launch and the init's factors; PSNR within 0.2 dB of a plain-BCD
    encode at the shapes new to bcd_grid; at those stacks `bcd_grid`
    against the plain version (`grid_stack_reading`) and its ms."""
    from lrf_tpu_torch.experiments import common as ex
    from lrf_tpu_torch.experiments import drivers
    from lrf_tpu_torch.ops import bcd as bcd_mod

    img = lt.read_image(os.path.join(HERE, "experiments", "data", "local7", ABLATION_IMAGE))
    check(img.shape == (3, 512, 768), f"{ABLATION_IMAGE} is {img.shape}")
    configs = [(a, lab, ex.qmf_params(q, **ov), q) for a, lab, ov in ABLATIONS for q in CHECK_Q]
    configs += [("colorspace", "RGB", drivers.rgb_qmf_params(q), q) for q in RGB_Q]
    readings = collections.defaultdict(list)
    grid = {}
    failed = []
    t0 = time.perf_counter()
    for ablation, lab, params, q in configs:
        stacks = codec_stacks(torch, img, params)
        want = planned_launches(bk, stacks, params["num_iters"])
        reset_counts(bk)
        row = lt.eval_compression(img, lt.qmf_encode, lt.qmf_decode, device="cuda", **params)
        got = dict(bk.KERNEL.counts)
        check(got == want, f"{ablation} {lab} q{q:.2f}: launched {got}, its stacks plan {want}")
        check(np.isfinite(row["PSNR (dB)"]), f"{ablation} {lab} q{q:.2f}: PSNR {row['PSNR (dB)']}")
        shapes = [tuple(xm.shape) + (r,) for xm, r in stacks]
        reading = dict(q=q, bpp=row["bit rate (bpp)"], psnr=row["PSNR (dB)"], dev_ms=row["encoding device time (ms)"],
                       launches={k: v for k, v in got.items() if v}, shapes=shapes)
        if params["num_iters"] == 0:
            xm, r = stacks[0]
            init = bcd_mod.svd_init(xm, r, bounds=tuple(params["bounds"]))
            reset_counts(bk)
            u, v, _ = bcd_mod.qmf_decompose(xm, r, num_iters=0, bounds=tuple(params["bounds"]))
            check(bk.KERNEL.launches == 0 and torch.equal(u, init[0]) and torch.equal(v, init[1]),
                  f"num_iters 0 q{q:.2f}: {bk.KERNEL.launches} launches, factors equal to the init's "
                  f"{torch.equal(u, init[0]) and torch.equal(v, init[1])}")
        if lab in NEW_SHAPES:
            with plain_bcd(bk):
                plain = lt.eval_compression(img, lt.qmf_encode, lt.qmf_decode, device="cuda", **params)
            reading["plain_dpsnr"] = row["PSNR (dB)"] - plain["PSNR (dB)"]
            if not abs(reading["plain_dpsnr"]) < 0.2:
                failed.append(f"{lab} q{q:.2f}: PSNR {row['PSNR (dB)']} against the plain-BCD encode's "
                              f"{plain['PSNR (dB)']}")
            if q != CHECK_Q[0]:
                for name, (xm, r) in zip(("Y", "Cb"), stacks[:2] if lab == "no patch" else stacks[:1]):
                    grid[(lab, name, round(q, 2))] = grid_stack_reading(torch, bk, bcd_mod, f"{lab} {name}", xm, r)
        if lab == "RGB" and q != RGB_Q[0]:
            xm, r = stacks[0]
            grid[("RGB patches", "RGB", round(q, 2))] = grid_stack_reading(torch, bk, bcd_mod, "RGB patches", xm, r)
        readings[(ablation, lab)].append(reading)
    for (ablation, lab), rs in readings.items():
        plain = [f"{r['plain_dpsnr']:+.4f}" for r in rs if "plain_dpsnr" in r]
        print(f"ablation [{label}] {ablation} {lab}: encode device ms median {np.median([r['dev_ms'] for r in rs]):.3f} "
              f"(per q {', '.join(f'{r['dev_ms']:.3f}' for r in rs)}); "
              + "; ".join(f"q{r['q']:.2f} {r['bpp']:.4f} bpp {r['psnr']:.4f} dB launches {r['launches']} stacks "
                          f"{r['shapes']}" for r in rs)
              + (f"; PSNR - plain-BCD encode {', '.join(plain)} dB" if plain else ""), flush=True)
    for (lab, name, q), g in grid.items():
        print(f"ablation [{label}] bcd_grid at {lab} {name} q{q} {g['shape']} ({g['where']}): {g['ms']:.4f} ms, bound "
              f"{g['bound_ms']:.6g} ms ({g['bound_by']}; {100 * g['bound_ms'] / g['ms']:.2f}% of it), plain "
              f"{g['plain_ms']:.4f} ms, equal share {g['eq']:.5f}, loss {g['loss'][0]:.6f} (plain {g['loss'][1]:.6f})",
              flush=True)
    print(f"ablation [{label}]: {len(configs)} configs in {time.perf_counter() - t0:.1f} s", flush=True)
    failed += [f"bcd_grid at {lab} {name} q{q} {g['shape']}: loss {g['loss']} (kernel, plain)"
               for (lab, name, q), g in grid.items() if not g["ok"]]
    check(not failed, f"ablations: {failed}")
    return grid


def sweep_curves(torch, lt, label: str, rows: list) -> None:
    """`aggregate` of the card's rows at 0.2 and 0.3 bpp; LOESS of each QMF
    curve on the card against the CPU (within 1e-9, relative); the gap to
    the JAX package's stored rows (a reading: they are stale for QMF bpp)."""
    from lrf_tpu_torch.experiments import aggregate as agg
    from lrf_tpu_torch.experiments.plots import BPP_GRID

    for bpp in (0.2, 0.3):
        for metric in ("PSNR (dB)", "SSIM"):
            got = agg.aggregate(rows, bpp, metric)
            print(f"curves [{label}] aggregate @{bpp} bpp {metric}: "
                  f"{', '.join(f'{m} {v:.4f}' for m, v in got.items()) or 'no row in the window'}", flush=True)
    grid = np.asarray(BPP_GRID)
    frac = np.arange(0.15, 0.75, 0.1)
    worst, t_card, t_cpu = 0.0, 0.0, 0.0
    for image in sorted({r["data"] for r in rows}):
        qmf = [r for r in rows if r["data"] == image and r["method"] == "QMF"]
        x = [r["bit rate (bpp)"] for r in qmf]
        y = [r["PSNR (dB)"] for r in qmf]
        t0 = time.perf_counter()
        card = lt.LOESS(frac=frac, degree=[1, 2], device="cuda").fit(x, y)
        p_card = card.predict(grid).cpu().numpy()
        t1 = time.perf_counter()
        cpu = lt.LOESS(frac=frac, degree=[1, 2], device="cpu").fit(x, y)
        p_cpu = cpu.predict(grid).numpy()
        t_card, t_cpu = t_card + t1 - t0, t_cpu + time.perf_counter() - t1
        check((card.best_frac, card.best_degree) == (cpu.best_frac, cpu.best_degree),
              f"LOESS of {image}: best {(card.best_frac, card.best_degree)} on the card, "
              f"{(cpu.best_frac, cpu.best_degree)} on the CPU")
        rel = float(np.max(np.abs(p_card - p_cpu) / np.maximum(np.abs(p_cpu), 1e-12)))
        check(rel <= 1e-9, f"LOESS of {image}: card and CPU predictions {rel} apart (relative)")
        worst = max(worst, rel)
    print(f"curves [{label}] LOESS of the 7 QMF curves onto {len(grid)} bpp points: card and CPU within {worst:.3g} "
          f"(relative), the same (frac, degree); {t_card * 1e3:.1f} ms on the card, {t_cpu * 1e3:.1f} ms on the CPU",
          flush=True)
    with open(os.path.join(HERE, "experiments", "comparison", "local7_results.json")) as f:
        stored = json.load(f)

    def key(r):
        q = r["quality"]
        return r["data"], r["method"], round(float(q[0] if isinstance(q, (list, tuple)) else q), 6)

    by_key = {key(r): r for r in stored}
    for method in ("JPEG", "SVD", "QMF"):
        pairs = [(r, by_key[key(r)]) for r in rows if r["method"] == method and key(r) in by_key]
        d_psnr = [a["PSNR (dB)"] - b["PSNR (dB)"] for a, b in pairs]
        d_bpp = [a["bit rate (bpp)"] - b["bit rate (bpp)"] for a, b in pairs]
        print(f"curves [{label}] {method} against the JAX package's stored rows ({len(pairs)} points; a reading, not "
              f"a check): PSNR {np.mean(d_psnr):+.4f} dB mean, {min(d_psnr):+.4f}..{max(d_psnr):+.4f}; bpp "
              f"{np.mean(d_bpp):+.5f} mean, {min(d_bpp):+.5f}..{max(d_bpp):+.5f}", flush=True)


def sweep_entry(torch, lt, bk, bcd_mod, label: str) -> None:
    """`entry()`'s forward on the card: 3 `bcd_cluster` launches, int8
    factors within the bounds, deterministic; against the same forward with
    the plain BCD on the card (one init): more than 85% of entries equal and
    the fit's loss within 2e-3 (the kernel's contract); against the forward
    on the CPU, whose init comes from another eigensolver: the loss within
    2e-3, the equal share (column signs aligned) printed, since on this
    uniform-noise image the integer sweeps part from inits that differ in
    their last bits; both forwards again from one X and one init (the CPU's,
    `one_init`): the equal shares printed, and each stack that parts doing
    so first at round() ties (`first_parting` within TIE_DIST); then
    `dryrun_multichip(2)`."""
    from lrf_tpu_torch import entry as step
    from lrf_tpu_torch.ops import color, pad, patch, resample

    forward, (image,) = step.entry()
    check(image.is_cuda and image.dtype == torch.uint8 and tuple(image.shape) == (3, 512, 768), "entry image")
    reset_counts(bk)
    t_card, out = best_s(lambda: forward(image), reps=1)
    launches = dict(bk.KERNEL.counts)
    check(launches == only(bk, bcd_cluster=3), f"entry forward launched {launches}, expected bcd_cluster 3 times")
    t_again, again = best_s(lambda: forward(image), reps=3)
    check(all(torch.equal(a, b) for a, b in zip(out, again)), "entry forward is not deterministic")
    with plain_bcd(bk):
        out_plain = forward(image)
    forward_cpu, (image_cpu,) = step.entry(device="cpu")
    t0 = time.perf_counter()
    out_cpu = forward_cpu(image_cpu)
    t_cpu = time.perf_counter() - t0
    channels = resample.chroma_downsample(color.rgb_to_ycbcr(image.to(torch.float32)), (0.5, 0.5))
    notes, failed = [], []
    for c, channel in enumerate(channels):
        x = patch.patchify(pad.pad_image(channel, (8, 8)), (8, 8))
        u, v = out[2 * c], out[2 * c + 1]
        check(u.dtype == v.dtype == torch.int8 and int(u.min()) >= BOUNDS[0] and int(u.max()) <= BOUNDS[1]
              and int(v.min()) >= BOUNDS[0] and int(v.max()) <= BOUNDS[1], f"entry factor {c}: dtype or bounds")
        u, v = u.to(torch.float32), v.to(torch.float32)
        up, vp = out_plain[2 * c].to(torch.float32), out_plain[2 * c + 1].to(torch.float32)
        eq_plain = min(float((u == up).float().mean()), float((v == vp).float().mean()))
        loss, loss_plain = float(bcd_mod.qmf_loss(x, u, v)), float(bcd_mod.qmf_loss(x, up, vp))
        if not (eq_plain > 0.85 and abs(loss - loss_plain) < 2e-3):
            failed.append(f"channel {c}: equal share {eq_plain} against the plain BCD on the card, loss {loss} vs "
                          f"{loss_plain}")
        uc, vc = out_cpu[2 * c].to(torch.float32), out_cpu[2 * c + 1].to(torch.float32)
        u, v = u.cpu(), v.cpu()
        sign, _ = column_signs(torch, u, uc)
        u, v = u * sign, v * sign
        eq_cpu = min(float((u == uc).float().mean()), float((v == vc).float().mean()))
        loss_cpu = float(bcd_mod.qmf_loss(x.cpu(), uc, vc))
        if not abs(loss - loss_cpu) < 2e-3:
            failed.append(f"channel {c}: loss {loss} on the card, {loss_cpu} on the CPU")
        notes.append(f"{('Y', 'Cb', 'Cr')[c]} {tuple(u.shape)}/{tuple(v.shape)}: loss {loss:.6f}; plain BCD on the card "
                     f"equal {eq_plain:.5f}, loss {loss_plain:.6f}; CPU equal {eq_cpu:.5f} ({int((sign < 0).sum())} "
                     f"columns re-signed), loss {loss_cpu:.6f}")
    print(f"entry [{label}]: forward on the card launched {launches}; {t_card * 1e3:.1f} ms first, {t_again * 1e3:.2f} "
          f"ms best of 3 (host clock), CPU {t_cpu * 1e3:.1f} ms; {'; '.join(notes)}", flush=True)
    # the cause behind the unheld CPU share, measured: both forwards from one
    # X and one init (the CPU's)
    rec_card, rec_cpu = [], []
    with one_init(torch, bcd_mod, bcd_mod, rec_card):
        fwd, (img,) = step.entry()
        out_one = fwd(img)
    with one_init(torch, bcd_mod, bcd_mod, rec_cpu, stacks=rec_card):
        fwd, (img,) = step.entry(device="cpu")
        out_one_cpu = fwd(img)
    eq_one = [equal_share(torch, a, b) for a, b in zip(out_one, out_one_cpu)]
    partings = [first_parting(torch, bcd_mod, a[0], a[1].shape[-1]) for a, b in zip(rec_card, rec_cpu)
                if not (torch.equal(a[1].cpu(), b[1]) and torch.equal(a[2].cpu(), b[2]))]
    print(f"entry [{label}]: from one X and one init, card (planned kernels) against CPU (plain sweeps): factor entries "
          f"equal {', '.join(f'{e:.6f}' for e in eq_one)} (U, V of Y, Cb, Cr); the CPU's own X equal to the card's in "
          f"{min(r[3] for r in rec_cpu):.6f} of entries; where they part (sweep, pass, entries, largest distance "
          f"from a rounding tie): {partings or 'nowhere'}", flush=True)
    if not all(at and at[3] < TIE_DIST for at in partings):
        failed.append(f"from one X and one init the forwards part away from a rounding tie: {partings}")
    check(not failed, f"entry forward: {failed}")
    t0 = time.perf_counter()
    step.dryrun_multichip(2)
    print(f"entry [{label}]: dryrun_multichip(2) on {step._default_devices(2)} passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def sweep_figures(label: str, rows: list, tmp: str) -> None:
    """The comparison figures of the card's rows, where this machine has
    matplotlib, pandas and seaborn; else what is missing."""
    import importlib.util

    missing = [m for m in ("matplotlib", "pandas", "seaborn") if importlib.util.find_spec(m) is None]
    if missing:
        print(f"figures [{label}]: this machine lacks {', '.join(missing)}: nothing drawn (the CPU tests draw them)",
              flush=True)
        return
    from lrf_tpu_torch.experiments.plots import plot_comparison
    from lrf_tpu_torch.utils.config import save_config

    save_config(rows, save_dir=tmp, prefix="card")
    t0 = time.perf_counter()
    plot_comparison(os.path.join(tmp, "card_results.json"), save_dir=os.path.join(tmp, "figs"), prefix="card")
    figs = sorted(os.listdir(os.path.join(tmp, "figs")))
    check(len(figs) == 4, f"figures {figs}")
    print(f"figures [{label}]: {', '.join(figs)} drawn from the card's rows in {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_sweeps(torch, lt, bk, label: str) -> None:
    """Phase 12: the sweep layer on the card (the card's X and exact init
    against the CPU's, comparison sweep with resume, CPU cross-check, the four
    ablations, aggregates and LOESS curves, the codec step and the dry run,
    the figures)."""
    import tempfile

    from lrf_tpu_torch.ops import bcd as bcd_mod

    clock = [time.perf_counter()]

    def lap(part: str) -> None:
        clock.append(time.perf_counter())
        print(f"phase 12 {part}: {clock[-1] - clock[-2]:.1f} s [{label}]", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        sweep_front_end(torch, lt, label)
        lap("the card's X")
        sweep_init(torch, lt, label)
        lap("the card's init")
        rows, _ = sweep_comparison(torch, lt, bk, label, tmp)
        lap("comparison sweep")
        sweep_cpu_check(torch, lt, bk, label)
        lap("CPU cross-check")
        sweep_ablations(torch, lt, bk, label)
        lap("ablations")
        sweep_curves(torch, lt, label, rows)
        lap("aggregates and curves")
        sweep_entry(torch, lt, bk, bcd_mod, label)
        lap("entry")
        sweep_figures(label, rows, tmp)
        lap("figures")


DRIVER_SIZE = (512, 768)
WALK_IMAGE = os.path.join("experiments", "data", "demo", "kodim01.png")
WALK_QUALITY = 7


def driver_argv(out_dir: str) -> list[str]:
    """The dataset driver's arguments in phase 13: the local7 images at
    512x768, q10, on every visible card."""
    return ["--data_dir", os.path.join(HERE, "experiments", "data", "local7"), "--out_dir", out_dir,
            "--size", *map(str, DRIVER_SIZE), "--quality", "10", "--device", "cuda"]


def driver_worker(out_dir: str) -> int:
    """One process of phase 13's two-process dataset encode (`--driver-worker`;
    RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT come from the parent)."""
    sys.path.insert(0, HERE)
    from lrf_tpu_torch.experiments import distributed_encode as de

    return de.main(driver_argv(out_dir) + ["--multihost"])


def read_streams(out_dir: str, paths) -> list[bytes]:
    blobs = []
    for p in paths:
        with open(os.path.join(out_dir, os.path.splitext(os.path.basename(p))[0] + ".qmf"), "rb") as f:
            blobs.append(f.read())
    return blobs


def phase_drivers(torch, lt, bk, label: str) -> None:
    """Phase 13: the dataset encode driver and the walkthrough on the card.

    `distributed_encode` over the seven local7 images at 512x768, q10, in
    this process on every visible card: its files byte-equal, in order, to
    `sharded_qmf_encode_batch` of the same tiled and cropped images on one
    card, `bcd_cluster` launched 2 times per batch of each card and no other
    kernel; then as two `--multihost` processes (gloo, env://, both on the
    card, this script re-run with `--driver-worker`), whose files must equal
    the one-process files; the planned kernel and the plain version timed at
    the batch's two stacks, beside the bound. The walkthrough
    (`qmf_pipeline.stages`) of
    kodim01.png at q7 on the card (3 `bcd_cluster` launches) and on this
    machine's CPU: equal metadata, decoded pixels at most 1 apart in under
    0.1% of pixels, PSNR within 0.01 dB; its stage times."""
    import io
    import socket
    import tempfile

    from lrf_tpu_torch.experiments import distributed_encode as de
    from lrf_tpu_torch.experiments import qmf_pipeline as qp
    from lrf_tpu_torch.experiments.common import dataset_images

    failed = []
    paths = dataset_images(os.path.join(HERE, "experiments", "data", "local7"))
    check(len(paths) == 7, f"local7 holds {len(paths)} PNGs, expected 7")
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        reset_counts(bk)
        with contextlib.redirect_stdout(out):
            rc = de.main(driver_argv(os.path.join(tmp, "one")))
        launches = dict(bk.KERNEL.counts)
        check(rc == 0, f"distributed_encode exited {rc}")
        rate = out.getvalue().strip().splitlines()[-1]
        print(f"drivers [{label}]: distributed_encode, one process on {cards} card(s): {rate}", flush=True)
        got = read_streams(os.path.join(tmp, "one"), paths)
        images = de.load_dataset(paths, DRIVER_SIZE)
        want = lt.sharded_qmf_encode_batch(images, quality=10, device="cuda")
        same = sum(a == b for a, b in zip(got, want))
        if launches != only(bk, bcd_cluster=2 * cards):
            failed.append(f"the driver launched {launches}, expected bcd_cluster {2 * cards} times")
        if got != want:
            failed.append(f"{same}/7 files equal to sharded_qmf_encode_batch on one card")

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--driver-worker",
                                   os.path.join(tmp, "two")], env=dict(env, RANK=str(rank)),
                                  stdout=subprocess.PIPE, text=True) for rank in range(2)]
        try:
            outs = [p.communicate(timeout=400)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check([p.returncode for p in procs] == [0, 0], f"two-process dataset encode exited "
              f"{[p.returncode for p in procs]}")
        two = read_streams(os.path.join(tmp, "two"), paths)
        same_two = sum(a == b for a, b in zip(two, got))
        print(f"drivers [{label}]: distributed_encode --multihost, two processes on the card: "
              f"{outs[0].strip().splitlines()[-1]}; {same_two}/7 files equal to the one-process files; "
              f"{time.perf_counter() - t0:.1f} s with process start-up", flush=True)
        if two != got:
            failed.append(f"two-process files: {same_two}/7 equal to the one-process files")

    from lrf_tpu_torch.ops import bcd as bcd_mod

    for what, x, u0, v0 in batch_stacks(torch, lt, bcd_mod, images):
        b, m, n = x.shape
        r = u0.shape[-1]
        variant = bk.KERNEL.plan(m, n, r).variant
        ms = cuda_ms(lambda: run_variant(bk, x, u0, v0, BOUNDS, variant), 20)
        plain_ms = cuda_ms(lambda: bk.bcd_reference(x, u0, v0, ITERS, BOUNDS), 3)
        bound, by = bcd_bound_ms(b, m, n, r, ITERS)
        print(f"drivers [{label}]: the driver's {what}: {variant} {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound:.6g} ms ({by}; {100 * bound / ms:.2f}%)", flush=True)

    image = lt.read_image(os.path.join(HERE, WALK_IMAGE))
    reset_counts(bk)
    card = qp.stages(image, WALK_QUALITY, device="cuda")
    launches = dict(bk.KERNEL.counts)
    card = qp.stages(image, WALK_QUALITY, device="cuda")  # warm: the stage times
    cpu = qp.stages(image, WALK_QUALITY, device="cpu")
    diff = np.abs(card["decoded"].astype(np.int16) - cpu["decoded"].astype(np.int16))
    print(f"drivers [{label}]: walkthrough of {WALK_IMAGE} {image.shape} at q{WALK_QUALITY}: launched {launches}; "
          f"metadata {'equal' if card['metadata'] == cpu['metadata'] else 'apart'}; {card['bpp']:.4f} bpp on the "
          f"card, {cpu['bpp']:.4f} on the CPU; PSNR {card['psnr']:.4f} / {cpu['psnr']:.4f} dB, SSIM "
          f"{card['ssim']:.6f} / {cpu['ssim']:.6f}; rank-1 energy {np.round(card['energy'], 4).tolist()} / "
          f"{np.round(cpu['energy'], 4).tolist()}; decoded pixels max |diff| {int(diff.max())}, "
          f"{float((diff > 0).mean()):.6f} of them apart; streams "
          f"{'byte-identical' if card['encoded'] == cpu['encoded'] else 'apart'}", flush=True)
    for side, st in (("card", card), ("CPU", cpu)):
        print(f"drivers [{label}]: walkthrough stage ms on the {side}: "
              f"{', '.join(f'{k} {1e3 * t:.3f}' for k, t in st['seconds'].items())}", flush=True)
    if launches != only(bk, bcd_cluster=3):
        failed.append(f"the walkthrough launched {launches}, expected bcd_cluster 3 times")
    if card["metadata"] != cpu["metadata"]:
        failed.append(f"walkthrough metadata {card['metadata']} on the card, {cpu['metadata']} on the CPU")
    if not (int(diff.max()) <= 1 and float((diff > 0).mean()) < 1e-3):
        failed.append(f"walkthrough pixels: max |diff| {int(diff.max())}, {float((diff > 0).mean())} apart")
    if abs(card["psnr"] - cpu["psnr"]) >= 0.01:
        failed.append(f"walkthrough PSNR {card['psnr']} on the card, {cpu['psnr']} on the CPU")
    check(not failed, f"phase 13: {failed}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist-worker", nargs=3, metavar=("RANK", "PORT", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--driver-worker", metavar="OUT_DIR", help=argparse.SUPPRESS)
    ap.add_argument("--phases", default=",".join(map(str, OPTIONAL_PHASES)),
                    help="comma-separated phases to run besides 1, 2 and 4 (default: all); a partial run prints "
                    "its readings but no result lines")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",") if p}
    if not phases <= set(OPTIONAL_PHASES):
        ap.error(f"--phases takes some of {OPTIONAL_PHASES}")
    if args.dist_worker:
        rank, port, out_path = args.dist_worker
        return dist_worker(int(rank), int(port), out_path, args.seed)
    if args.driver_worker:
        return driver_worker(args.driver_worker)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import lrf_tpu_torch as lt
    from lrf_tpu_torch.ops import bcd as bcd_mod
    from lrf_tpu_torch.ops import bcd_kernel as bk

    t_start = time.perf_counter()
    label = card_line()
    print(label, flush=True)

    t0 = time.perf_counter()
    bk.KERNEL.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s for {', '.join(bk.SOURCES.values())}, one nvcc each "
          f"({' '.join(bk.NVCC_FLAGS)}); each nvcc ended after {bk.KERNEL.build_seconds} s")
    for line in ptxas_summary(bk.KERNEL.build_log):
        print(f"build: {line}")
    from lrf_tpu_torch.native import fibercodec as native

    t0 = time.perf_counter()
    backends = native.backends()
    print(f"build: native fiber coder {native.LIB.library_path().name} compiled in {native.LIB.build_seconds} s, "
          f"loaded in {time.perf_counter() - t0:.2f} s (g++ {' '.join(native.CXX_FLAGS)}); backends {backends}; "
          f"{os.cpu_count()} host cores", flush=True)

    clock = [time.perf_counter()]

    def lap(phase: int) -> None:
        clock.append(time.perf_counter())
        print(f"phase {phase}: {clock[-1] - clock[-2]:.1f} s", flush=True)

    if 3 in phases:
        per_shape = phase_kernel(torch, bk, bcd_mod, args.seed, main_path_stacks(torch, lt, bcd_mod, args.seed))
        lap(3)
    main_run = phase_main_path(torch, lt, bk, args.seed, label)
    lap(4)
    if 3 in phases:
        kernel_ms = sum(per_shape[s]["ms"]["bcd_cluster"] for s in MAIN_SHAPES)
        print(f"main path [{label}]: BCD kernel {kernel_ms:.3f} ms of the {main_run['device_ms']:.3f} ms device part "
              f"({100 * kernel_ms / main_run['device_ms']:.1f}%) and of the {main_run['enc_ms']:.2f} ms encode "
              f"({100 * kernel_ms / main_run['enc_ms']:.1f}%), from the phase-3 times at the same shapes")
    if 5 in phases:
        phase_variants(torch, lt, bk, args.seed)
        lap(5)
    if 6 in phases:
        batches, deflate_run = phase_host_tail(torch, lt, bk, args.seed, label)
        lap(6)
    if 7 in phases:
        phase_fast_init(torch, lt, bk, args.seed, label, main_run["streams"], main_run["dec"])
        lap(7)
    if 8 in phases:
        phase_dpack(torch, lt, args.seed, label, main_run["streams"], main_run["dec"],
                    batches if 6 in phases else [main_run["streams"]])
        lap(8)
    if 9 in phases:
        phase_mesh(torch, lt, bk, args.seed, label, main_run["streams"])
        lap(9)
    if 10 in phases:
        paths = phase_eval(torch, lt, bk, args.seed, label, main_run)
        lap(10)
    if 11 in phases:
        phase_secondary(torch, lt, bk, args.seed, label)
        lap(11)
    if 12 in phases:
        phase_sweeps(torch, lt, bk, label)
        lap(12)
    if 13 in phases:
        phase_drivers(torch, lt, bk, label)
        lap(13)
    if phases != set(OPTIONAL_PHASES):
        print(f"total: {time.perf_counter() - t_start:.1f} s; partial run (phases 1, 2, 4 and {sorted(phases)}): "
              f"no result lines")
        return 0

    main_keys = MAIN_SHAPES + [k for k in per_shape if isinstance(k, str)]
    entries = []
    for name, source in (("bcd_cluster", "lrf_tpu_torch/csrc/bcd_cluster.cu"), ("bcd", "lrf_tpu_torch/csrc/bcd.cu")):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": REPLACES,
            "launches": main_run["launches"][name],
            "max_abs_err": max(per_shape[k]["err"][name] for k in main_keys),
            "ms": sum(per_shape[s]["ms"][name] for s in MAIN_SHAPES),
            "plain_ms": sum(per_shape[s]["plain_ms"] for s in MAIN_SHAPES),
            "bound_ms": sum(per_shape[s]["bound_ms"] for s in MAIN_SHAPES),
            "bound_by": per_shape[MAIN_SHAPES[0]]["bound_by"],
            "library_ms": None,
            "shapes": [list(s) for s in MAIN_SHAPES],
            "path": "phase 4: sharded_qmf_encode_batch, 64 x 512x768 at q10",
            "card": label,
        })
    # The wide ranks' path: the q40 per-image encodes of phase 10, whose Y
    # stack they run; bcd_grid's: the q75 ones, whose Y stack it runs (its
    # error also over every phase-3 shape it took).
    grid_keys = [k for k in per_shape if "bcd_grid" in per_shape[k]["err"]]
    for pos, (name, source, q) in enumerate((("bcd_cluster_wide", "lrf_tpu_torch/csrc/bcd_cluster_wide.cu", 40),
                                            ("bcd_grid", "lrf_tpu_torch/csrc/bcd_grid.cu", 75))):
        path = paths[q]
        err = path["err"][name]
        if name == "bcd_grid":
            err = max([err] + [per_shape[k]["err"]["bcd_grid"] for k in grid_keys])
        entries.insert(1 + pos, {
            "name": name,
            "route": "cuda",
            "source": source,
            **({"template": "lrf_tpu_torch/csrc/bcd_cluster.cuh"} if name == "bcd_cluster_wide" else {}),
            "replaces": REPLACES,
            "launches": path["launches"][name],
            "max_abs_err": err,
            "ms": path["ms"][name],
            "plain_ms": path["plain_ms"],
            "bound_ms": path["bound_ms"],
            "bound_by": path["bound_by"],
            "library_ms": None,
            "shapes": [list(path["shape"])],
            "path": f"phase 10: qmf_encode of 4 bench images at q{q}",
            "card": label,
        })
    entries.append({
        "name": "deflate",
        "route": "cuda",
        "source": "lrf_tpu_torch/csrc/deflate.cu",
        "template": "lrf_tpu_torch/csrc/deflate_core.h",
        "replaces": "none: the JAX package's per-fiber zlib-9 runs on the host (lrf_tpu/native/fibercodec.cpp)",
        "launches": main_run["deflate_launches"],
        "max_abs_err": 0,  # byte-identical streams, checked in phase 6
        "ms": deflate_run["ms"],
        "plain_ms": deflate_run["plain_ms"],
        "bound_ms": deflate_run["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shapes": deflate_run["shapes"],
        "path": "phase 4: sharded_qmf_encode_batch, 64 x 512x768 at q10 (plain_ms: the host's zlib-9 pool)",
        "card": label,
    })
    for e in entries:
        check(e["name"] == "bcd" or e["launches"] > 0, f"{e['name']} was not launched on its path")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(label)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
