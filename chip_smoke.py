#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`lrf_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases 3,5,6,7,8,9,10]

Phases, each of which raises (exit code != 0) when a check fails:

1. card: the `nvidia-smi` name and power limit line;
2. build: compile the BCD kernels for sm_90a, one nvcc per source, all
   started together: the cluster kernel of `lrf_tpu_torch/csrc/
   bcd_cluster.cuh` (a thread-block cluster per image, X held in shared
   memory across sweeps; N = 64) at R <= 16 from `bcd_cluster.cu` and at
   17 <= R <= 32 from `bcd_cluster_wide.cu`, and `lrf_tpu_torch/csrc/
   bcd.cu` (one block per image; every shape, and the only one for
   N != 64 or R > 32); ptxas registers and spills per source and rank;
3. each kernel that takes a shape against the plain PyTorch version, both
   on the card: integer values inside the bounds, mean loss within 2e-3,
   more than 85% of factor entries equal, two launches bitwise equal,
   image 0 alone bitwise equal to image 0 in the batch, and the public
   `bcd` equal to the kernel its plan picks. The shapes are the codec's
   with integer X, and the main path's own float Y and merged Cb+Cr stacks
   with their shared-eigh init; bit-equal to the plain version on integer
   X at the test shapes. At the N = 64 regimes (bench Y and chroma,
   CLIC-size Y, the q40 Y stack alone and in a batch of 64) the planned
   cluster kernel and `bcd.cu` are timed in turns in the same run, beside
   the plain version's time and the computed bound;
4. the main path at full width: `sharded_qmf_encode_batch` of 64 RGB
   512x768 images at quality 10, then `sharded_qmf_decode_batch`; the
   R <= 16 cluster kernel must be launched exactly twice (Y, merged Cb+Cr)
   and the others not at all, per-image `qmf_decode` must give the batched
   decode's pixels, and per-image PSNR must be within 0.2 dB of an encode
   whose BCD is the plain version;
5. per-image round trips of the other codec variants on the card, each
   held against the same encode on the CPU at a small size;
6. the host tail at the same width: the native fiber coder's build and
   backends; one encode with each transport (raw factors, the flat pack,
   the entropy pack), whose streams must be byte-identical, with each
   mode's encode, host and device times; the native serializer against the
   plain pure-Python one on the same fetched factors (equal bytes under
   the "zlib" coder); the synchronizing CUDA calls of one encode; then
   `sharded_qmf_encode_batches` over 8 batches, which must give the
   one-shot streams in order with 16 cluster-kernel launches, and
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
   beside one card's in the same run, and on several rows a
   `torch.profiler` trace of each device's kernel span; a patch mesh of 2
   (the cards, or `cuda:0` twice) on 8 images: no kernel launch, PSNR
   within 0.2 dB of the unsharded encode, no synchronizing call inside
   `sharded_bcd`'s sweep loop (`torch.cuda.set_sync_debug_mode`), its
   first and best-of-3 times and a profiler table; a two-process
   `distributed_encode` (gloo; this script re-run with `--dist-worker`,
   both processes on the card) of 16 images: streams in order, equal to
   one process's encodes of the same shards;
10. eval: `eval_compression` with `qmf_encode` / `qmf_decode` of 4 bench
   images at quality 10, 25 and 40: bpp, PSNR, SSIM, encode, decode and
   encode device ms; each stack's shape and kernel (q10 and q25 launch
   only the R <= 16 cluster kernel, q40's Y stack the wide one); PSNR and
   SSIM on the card equal to the CPU's within 1e-5; the planned kernel
   timed at every per-image stack, and at the q40 Y stack the wide cluster
   kernel and `bcd.cu` in turns, each with its share of the median q40
   encode's device ms; a batched q40 encode of the 64 bench images (one
   launch of each cluster kernel, per-image PSNR within 0.2 dB of an
   encode whose BCD is the plain version);
   `device_benchmark` of the bench encode (five runs taken in phase 4
   right after its three timed calls, so both see the same host): its best
   within the spread of those calls (or twice its own deviation) of theirs.

It prints one JSON line of per-kernel numbers (for the R <= 16 cluster
kernel and `bcd.cu` summed over the two main-path shapes; for the wide
cluster kernel at the q40 Y stack, its launches counted over phase 10's q40
encodes), then as its last line
`{"ok": true, "device": {...}}`. It needs one CUDA device; without one it
exits with code 1 and prints no result. It imports neither JAX nor
`lrf_tpu`. `--phases` runs 1, 2, 4 and the phases named (for example
`--phases 9,10` on a four-card machine); such a partial run prints no
result lines. Profiler traces go to `chiprun_out/traces/`.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import subprocess
import sys
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
# a per-image encode and of a batch of 64, and R = 32 (q50) streamed.
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
]
# Integer-X shapes at which a cluster kernel must equal the plain version
# bit for bit (every sum an exact integer below 2**24).
EXACT_SHAPES = [(3, 300, 64, 7), (2, 257, 64, 5), (1, 64, 64, 1), (2, 128, 64, 26), (2, 257, 64, 17)]
MAIN_SHAPES = [(64, 6144, 64, 6), (128, 1536, 64, 3)]
Q40_SHAPES = [(1, 6144, 64, 26), (64, 6144, 64, 26)]
# The N = 64 regimes where the planned cluster kernel and bcd.cu are timed in turns.
TIMED_SHAPES = MAIN_SHAPES + [(4, 49152, 64, 13)] + Q40_SHAPES
# What each kernel replaces (the TPU kernels' pallas_call sites).
REPLACES = "lrf_tpu/ops/bcd_pallas.py:519 (K1, K2), lrf_tpu/ops/bcd_pallas.py:722 (K3)"
# Phases that --phases can leave out; 1 (card), 2 (build) and 4 (main path) always run.
OPTIONAL_PHASES = (3, 5, 6, 7, 8, 9, 10)


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


def ptxas_summary(log: str) -> list[str]:
    """Registers and spills that ptxas reported, one line per source: each
    cluster-kernel rank (R=...) or the one-block kernel."""
    import re

    out, source, cur, parts = [], None, None, []
    for line in log.splitlines() + ["== end"]:
        if line.startswith("== "):
            if source and parts:
                out.append(f"{source}: " + "; ".join(parts))
            source, parts = line[3:].strip(), []
        elif "Compiling entry function" in line:
            rank = re.search(r"bcd_cluster_kernelILi(\d+)E", line)
            cur = f"R={rank.group(1)}" if rank else "kernel"
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
    """The kernels that take this shape: the cluster kernel whose ranks hold
    R at N = 64 (if any), then the one-block kernel, which takes every shape."""
    return [v for v in (bk.cluster_variant(n, r), "bcd") if v]


def only(bk, **want) -> dict:
    """Launch counts: `want` for the kernels named, 0 for every other."""
    return {name: want.get(name, 0) for name in bk.KERNEL.counts}


def check_contract(torch, bk, bcd_mod, label, x, u0, v0, bounds, ref, exact: bool = False) -> dict:
    """Every applicable kernel against `bcd_reference` (`ref`): integer values
    inside the bounds, mean loss within 2e-3, more than 85% of entries
    equal, two launches bitwise equal, image 0 alone equal to image 0 in the
    batch; with `exact`, a cluster kernel equal to `ref` bit for bit. The
    public `bcd` must give the planned kernel's result."""
    b, m, n = x.shape
    r = u0.shape[-1]
    ur, vr = ref
    loss_r = float(bcd_mod.qmf_loss(x, ur, vr).mean())
    lo, hi = bounds
    out = {}
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
        check(eq_u > 0.85 and eq_v > 0.85, f"{label} {variant}: equal share U {eq_u} V {eq_v}")
        check(torch.equal(uk, uk2) and torch.equal(vk, vk2), f"{label} {variant}: two launches differ")
        check(torch.equal(uk[:1], u1) and torch.equal(vk[:1], v1), f"{label} {variant}: image 0 depends on the batch")
        if exact and variant != "bcd":
            check(torch.equal(uk, ur) and torch.equal(vk, vr), f"{label} {variant}: not bit-equal on integer X")
        plan = bk.KERNEL.plan(m, n, r, variant)
        where = (f"cluster {plan.cluster} x {plan.rows_per_cta} rows, "
                 f"{'resident' if plan.resident else f'streamed in {plan.tile}-row tiles'}"
                 if variant != "bcd" else
                 f"{plan.tile}-row tiles, {'shared' if plan.state_in_smem else 'global'} state")
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
    """The planned cluster kernel and bcd.cu in turns (new, old, old, new)."""
    b, m, n = x.shape
    new = bk.KERNEL.plan(m, n, u0.shape[-1]).variant
    t = {new: [], "bcd": []}
    for variant in (new, "bcd", "bcd", new):
        reps = reps_new if variant == new else reps_old
        t[variant].append(cuda_ms(lambda: run_variant(bk, x, u0, v0, BOUNDS, variant), reps))
    return {k: sum(v) / len(v) for k, v in t.items()}


def phase_kernel(torch, bk, bcd_mod, seed: int, real_stacks):
    """Phase 3: every kernel that takes a shape against `bcd_reference` on
    the card, at the codec's shapes with integer X and at the main path's
    own float stacks; the same-run timing of the planned cluster kernel and
    bcd.cu at the N = 64 regimes of TIMED_SHAPES."""
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
            if bounds != BOUNDS:
                continue
            entry = dict(err={k: d["err"] for k, d in res.items()}, ms={})
            big = b * m * n > 10_000_000
            if shape in TIMED_SHAPES:
                entry["ms"] = time_pair(bk, x, u0, v0, 10 if big else 20, 3 if big else 10)
            else:
                entry["ms"] = {variants_for(bk, n, r)[0]: cuda_ms(lambda: bk.bcd(x, u0, v0, num_iters=ITERS), 3 if big else 10)}
            entry["plain_ms"] = cuda_ms(lambda: bk.bcd_reference(x, u0, v0, num_iters=ITERS), 2 if big else 3)
            entry["bound_ms"], entry["bound_by"] = bcd_bound_ms(b, m, n, r, ITERS)
            per_shape[shape] = entry
            times = ", ".join(f"{k} {v:.4f} ms ({100 * entry['bound_ms'] / v:.1f}% of bound)"
                              for k, v in entry["ms"].items())
            print(f"time {shape}: {times}; plain {entry['plain_ms']:.4f} ms; bound {entry['bound_ms']:.6g} ms "
                  f"({entry['bound_by']})", flush=True)
        if shape in TIMED_SHAPES:
            plan = bk.KERNEL.plan(m, n, r)
            print(f"plan {shape}: {plan}; {bk.KERNEL.max_active_clusters(plan, r)} clusters at once", flush=True)
    # The main path's own stacks: the float YCbCr planes and their shared-eigh init.
    for label, x, u0, v0 in real_stacks:
        ref = bk.bcd_reference(x, u0, v0, num_iters=ITERS, bounds=BOUNDS)
        res = check_contract(torch, bk, bcd_mod, label, x, u0, v0, BOUNDS, ref)
        per_shape[label] = dict(err={k: d["err"] for k, d in res.items()})
    return per_shape


def main_path_stacks(torch, lt, bcd_mod, seed: int):
    """The Y and merged Cb+Cr stacks of the main path at 64 x 512x768, q10,
    with their `svd_init_shared` init, as `build_sharded_encoder` makes them."""
    from lrf_tpu_torch.ops import color, pad, patch, resample

    images = load_images(seed)
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
    images = load_images(seed)
    b, _, h, w = images.shape
    mpix = b * h * w / 1e6

    for name in bk.KERNEL.counts:
        bk.KERNEL.counts[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = lt.sharded_qmf_encode_batch(images, quality=10, device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(bk.KERNEL.counts)
    check(launches == only(bk, bcd_cluster=2),
          f"main path launched the kernels {launches} times, expected bcd_cluster twice (Y, Cb+Cr)")
    print(f"main path: kernel launches {launches} in one encode of {b} images (first encode {first_s:.3f} s)")

    enc_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = lt.sharded_qmf_encode_batch(images, quality=10, device="cuda")
        enc_s.append(time.perf_counter() - t0)
    check(again == streams, "batched encode is not deterministic")

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

    # device_benchmark of the same encode right after the three calls, so
    # both see the same host; phase 10 holds the two against each other
    bench = lt.device_benchmark(lambda: lt.sharded_qmf_encode_batch(images, "cuda", 10), warmup=0, repeats=5,
                                pixels=b * h * w)
    enc_best, dec_best = min(enc_s), min(dec_s)
    print(f"main path: PSNR mean {p_kernel.mean():.4f} dB (min {p_kernel.min():.4f}); plain-BCD encode "
          f"max |dPSNR| {worst:.6f} dB, {same}/{b} streams byte-identical")
    print(f"main path [{label}]: encode {mpix / enc_best:.3f} Mpix/s ({enc_best * 1e3:.2f} ms per batch, "
          f"device part {device_ms:.3f} ms); decode {mpix / dec_best:.3f} Mpix/s ({dec_best * 1e3:.2f} ms)")
    print(f"main path [{label}]: of the {device_ms:.3f} ms device part, front end (color, chroma "
          f"downsample, pad, patchify) {front_ms:.3f} ms, init (Grams + eigh of {b + 2 * b} 64x64 matrices + "
          f"signs) {init_ms:.3f} ms; host part (fetch + native serializer) {enc_best * 1e3 - device_ms:.2f} ms")
    return dict(launches=launches, enc_ms=enc_best * 1e3, enc_all_ms=[t * 1e3 for t in enc_s], bench=bench,
                device_ms=device_ms, streams=streams, dec=dec)


def phase_variants(torch, lt, seed: int):
    """Phase 5: per-image round trips of the other variants on the card."""
    img = load_images(seed + 1, count=1)[0]
    small = np.ascontiguousarray(img[:, 100:164, 200:296])
    for kwargs in (
        dict(color_space="RGB", patch=True),
        dict(color_space="YCbCr", patch=False),
        dict(color_space="RGB", patch=False),
    ):
        dec = lt.qmf_decode(lt.qmf_encode(img, quality=10, device="cuda", **kwargs), device="cuda")
        check(dec.shape == img.shape and dec.dtype == np.uint8, f"{kwargs}: decoded {dec.shape}")
        p = float(per_image_psnr(img, dec))
        gpu = lt.qmf_decode(lt.qmf_encode(small, quality=10, device="cuda", **kwargs), device="cuda")
        cpu = lt.qmf_decode(lt.qmf_encode(small, quality=10, device="cpu", **kwargs), device="cpu")
        dp = abs(float(per_image_psnr(small, gpu)) - float(per_image_psnr(small, cpu)))
        check(np.isfinite(p) and p > 10.0, f"{kwargs}: PSNR {p}")
        check(dp < 0.2, f"{kwargs}: card vs CPU on a 64x96 crop differ by {dp} dB")
        print(f"variant {kwargs}: ok, 512x768 PSNR {p:.4f} dB; 64x96 card vs CPU |dPSNR| {dp:.6f} dB")


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
    from lrf_tpu_torch.ops import entropy
    from lrf_tpu_torch.parallel import decode as pdec
    from lrf_tpu_torch.parallel import encode as penc
    from lrf_tpu_torch.utils.transfer import HostCopy

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
        device_ms = cuda_ms(lambda: fn(x_dev), 3)
        enc_s, streams = best_s(lambda: lt.sharded_qmf_encode_batch(images, quality=10, device="cuda", pack=mode))
        out = fn(x_dev)
        d2h = sum(t.numel() * t.element_size() for t in out)
        fetch_s, host_out = best_s(lambda: penc._fetch_encoded(HostCopy(out), spec), 1)
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
              f"device part {device_ms:.3f} ms (CUDA events); fetch {fetch_s * 1e3:.3f} ms of {d2h} B; "
              f"host part (native serializer, best of 3) {ser_s * 1e3:.3f} ms{extra}", flush=True)
    raw = runs[None]["streams"]
    for mode in ("flat", "entropy"):
        check(runs[mode]["streams"] == raw, f"pack={mode} streams differ from the raw-factor streams")
    factors = runs[None]["host_out"]
    decoded = penc._decode_entropy(runs["entropy"]["host_out"], runs["entropy"]["spec"])
    check(all(np.array_equal(a, c) for a, c in zip(factors, decoded)), "entropy transport changed a factor value")
    print(f"host tail [{label}]: raw, flat and entropy transports give byte-identical streams ({b} of {b})")
    dev_factors = [torch.from_numpy(f).cuda() for f in factors]
    flat_ms = cuda_ms(lambda: penc._pack_factors(dev_factors, -16, 5), 10)
    budget = runs["entropy"]["spec"]["exc_budget"]
    entropy_ms = cuda_ms(lambda: entropy.pack_segments(dev_factors, max_exc_rows=budget), 10)
    print(f"host tail [{label}]: transport packs alone on the main path's factors (CUDA events, mean of 10): "
          f"flat {flat_ms:.3f} ms, entropy {entropy_ms:.3f} ms")

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
    pipe_s, got = best_s(lambda: list(lt.sharded_qmf_encode_batches(batches, quality=10, device="cuda")), 1)
    launches = dict(bk.KERNEL.counts)
    check(launches == only(bk, bcd_cluster=2 * n), f"pipelined encode launched {launches}")
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
    return one_shot


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
        print(f"fast init [{label}] init={mode}: init {dev_ms:.3f} ms on the device (CUDA events), {cpu_ms:.3f} ms of "
              f"host CPU; whole encode {enc_s * 1e3:.2f} ms ({mpix / enc_s:.3f} Mpix/s); the init launched "
              f"{len(names)} device kernels ({len(names) - ours} outside PyTorch's own at:: kernels, i.e. cuSOLVER "
              f"and cuBLAS) for {3 * b} matrices", flush=True)
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
    loop_syncs, encode_syncs = patch_mesh_syncs(torch, lt, small, patch_mesh)
    print(f"mesh [{label}]: patch mesh {patch_mesh} on {len(small)} x 512x768: plain sweeps across 2 shards (0 kernel "
          f"launches), {t * 1e3:.1f} ms (best of 3; first call {first * 1e3:.1f} ms); syncs inside sharded_bcd's sweep "
          f"loop {n_syncs(loop_syncs)}, in the whole encode {n_syncs(encode_syncs)}; PSNR within "
          f"{np.abs(dp).max():.6f} dB of the unsharded encode (mean {dp.mean():+.6f}); "
          f"{sum(a == c for a, c in zip(got, want))}/{len(small)} streams equal", flush=True)
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


def phase_eval(torch, lt, bk, seed: int, label: str, main_run) -> dict:
    """Phase 10: `eval_compression` of 4 bench images at q10, q25 and q40
    on the card, the kernel each stack launched, card metrics against CPU
    metrics, the planned kernel at every per-image stack (the wide cluster
    kernel and `bcd.cu` in turns at the q40 Y stack), and `device_benchmark`
    of the bench encode against phase 4's three calls."""
    from lrf_tpu_torch.ops import bcd as bcd_mod
    from lrf_tpu_torch.ops import color, pad, patch, resample
    from lrf_tpu_torch.utils import metrics as tm

    images = load_images(seed)
    _, _, h, w = images.shape
    chroma = resample.scaled_size((h, w), (0.5, 0.5))
    ms = [(h // 8) * (w // 8), (chroma[0] // 8) * (chroma[1] // 8), (chroma[0] // 8) * (chroma[1] // 8)]
    device_ms = {}
    ranks = {}
    q40_launches = only(bk)
    for q in (10, 25, 40):
        ranks[q] = lt.build_sharded_encoder("cuda", (h, w), quality=q)[1]["rank"]
        plans = [bk.KERNEL.plan(m, 64, r).variant for m, r in zip(ms, ranks[q])]
        want = {name: plans.count(name) for name in bk.KERNEL.counts}
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
            if q == 40:
                q40_launches = {k: q40_launches[k] + counts[k] for k in counts}
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
    print(f"eval [{label}] q40: launches over the 4 per-image encodes {q40_launches}", flush=True)

    # The batched q40 encode of the 64 bench images: Y (64, 6144, 64, 26) on
    # the wide cluster kernel, merged Cb+Cr on the R <= 16 one; per-image
    # PSNR within 0.2 dB of an encode whose BCD is the plain version.
    m_y = ms[0]
    want = {name: 0 for name in bk.KERNEL.counts}
    for m, r in ((m_y, ranks[40][0]), (ms[1], ranks[40][1])):
        want[bk.KERNEL.plan(m, 64, r).variant] += 1
    for name in bk.KERNEL.counts:
        bk.KERNEL.counts[name] = 0
    streams = lt.sharded_qmf_encode_batch(images, quality=40, device="cuda")
    batch_launches = dict(bk.KERNEL.counts)
    check(batch_launches == want, f"batched q40 encode launched {batch_launches}, expected {want}")
    enc_s, again = best_s(lambda: lt.sharded_qmf_encode_batch(images, quality=40, device="cuda"))
    check(again == streams, "batched q40 encode is not deterministic")
    plain = lt.sharded_qmf_encode_batch(images, quality=40, device="cuda", backend="torch")
    p_kernel = per_image_psnr(images, lt.sharded_qmf_decode_batch(streams, device="cuda"))
    p_plain = per_image_psnr(images, lt.sharded_qmf_decode_batch(plain, device="cuda"))
    worst = float(np.abs(p_kernel - p_plain).max())
    check(worst < 0.2, f"batched q40: PSNR differs from the plain-BCD encode by {worst} dB")
    print(f"eval [{label}] q40 batched encode of {len(images)} images: launches {batch_launches}; "
          f"{enc_s * 1e3:.2f} ms (best of 3); PSNR mean {p_kernel.mean():.4f} dB, max |dPSNR| against the "
          f"plain-BCD encode {worst:.6f} dB, {sum(a == c for a, c in zip(streams, plain))}/{len(images)} streams "
          f"byte-identical", flush=True)

    # The planned kernel at each per-image stack of image 0 (Y, and Cb, whose
    # shape and rank Cr shares), as `qmf_encode` runs it; at the q40 Y stack
    # the wide cluster kernel and bcd.cu in turns.
    x = torch.from_numpy(images[:1]).cuda()
    planes = resample.chroma_downsample(color.rgb_to_ycbcr(x), (0.5, 0.5))
    stacks = [patch.patchify(pad.pad_image(c, (8, 8)), (8, 8)).contiguous() for c in planes[:2]]
    timed = {}
    for q in (10, 25, 40):
        enc_dev = float(np.median(device_ms[q]))
        for name, y, r in zip(("Y", "Cb"), stacks, ranks[q][:2]):
            u0, v0, _ = bcd_mod.svd_init(y, r, bounds=BOUNDS)
            ur, vr = bk.bcd_reference(y, u0, v0, num_iters=ITERS, bounds=BOUNDS)
            shape = tuple(y.shape) + (r,)
            planned = bk.KERNEL.plan(*shape[1:]).variant
            variants = [planned, "bcd"] if q == 40 and name == "Y" else [planned]
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
    q40 = dict(timed[(40, "Y")], launches=q40_launches, per_stack=timed)

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
    return q40


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist-worker", nargs=3, metavar=("RANK", "PORT", "OUT"), help=argparse.SUPPRESS)
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
          f"({' '.join(bk.NVCC_FLAGS)}); each nvcc seen done after {bk.KERNEL.build_seconds} s")
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
        phase_variants(torch, lt, args.seed)
        lap(5)
    if 6 in phases:
        batches = phase_host_tail(torch, lt, bk, args.seed, label)
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
        q40 = phase_eval(torch, lt, bk, args.seed, label, main_run)
        lap(10)
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
    # The wide ranks' path: the q40 per-image encodes of phase 10, whose Y stack it runs.
    entries.insert(1, {
        "name": "bcd_cluster_wide",
        "route": "cuda",
        "source": "lrf_tpu_torch/csrc/bcd_cluster_wide.cu",
        "template": "lrf_tpu_torch/csrc/bcd_cluster.cuh",
        "replaces": REPLACES,
        "launches": q40["launches"]["bcd_cluster_wide"],
        "max_abs_err": q40["err"]["bcd_cluster_wide"],
        "ms": q40["ms"]["bcd_cluster_wide"],
        "plain_ms": q40["plain_ms"],
        "bound_ms": q40["bound_ms"],
        "bound_by": q40["bound_by"],
        "library_ms": None,
        "shapes": [list(q40["shape"])],
        "path": "phase 10: qmf_encode of 4 bench images at q40",
        "card": label,
    })
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
