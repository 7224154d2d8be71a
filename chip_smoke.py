#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`lrf_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises (exit code != 0) when a check fails:

1. card: the `nvidia-smi` name and power limit line;
2. build: compile `lrf_tpu_torch/csrc/bcd.cu` for sm_90a with nvcc;
3. the BCD kernel against its plain PyTorch version, both on the card, at
   the shapes the codec gives it: integer values inside the bounds, mean
   loss within 2e-3, more than 85% of factor entries equal, two launches
   bitwise equal, image 0 alone bitwise equal to image 0 in the batch;
   with the kernel's time, the plain version's time and the computed bound;
4. the main path at full width: `sharded_qmf_encode_batch` of 64 RGB
   512x768 images at quality 10, then `sharded_qmf_decode_batch`; the
   kernel must be launched exactly twice (Y, merged Cb+Cr), per-image
   `qmf_decode` must give the batched decode's pixels, and per-image PSNR
   must be within 0.2 dB of an encode whose BCD is the plain version;
5. per-image round trips of the other codec variants on the card, each
   held against the same encode on the CPU at a small size.

It prints one JSON line of per-kernel numbers, then as its last line
`{"ok": true, "device": {...}}`. It needs one CUDA device; without one it
exits with code 1 and prints no result. It imports neither JAX nor
`lrf_tpu`.
"""

from __future__ import annotations

import argparse
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
# CLIC-size Y (the regime of the TPU's per-image kernel).
KERNEL_SHAPES = [
    (3, 300, 64, 7),
    (2, 257, 64, 5),
    (1, 64, 64, 1),
    (2, 128, 64, 26),
    (2, 128, 64, 64),
    (1, 512, 768, 51),
    (1, 6144, 192, 96),
    (64, 6144, 64, 6),
    (128, 1536, 64, 3),
    (4, 49152, 64, 13),
]
MAIN_SHAPES = [(64, 6144, 64, 6), (128, 1536, 64, 3)]


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


def bcd_bound_ms(b: int, m: int, n: int, r: int, iters: int) -> tuple[float, str]:
    """Least time for `iters` BCD sweeps: each input read once, each output
    written once, against the f32 flops of the sweeps."""
    nbytes = 4 * b * (m * n + 2 * (m * r + n * r))
    flops = iters * b * 4 * (m * n * r + m * r * r + n * r * r)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel(torch, bk, bcd_mod, seed: int):
    """Phase 3: the kernel against `bcd_reference` on the card."""
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
            check(bk.KERNEL.launches == launches, f"{shape}: num_iters=0 launched the kernel")
            check(torch.equal(uz, u0) and torch.equal(vz, v0), f"{shape}: num_iters=0 changed the init")

            uk, vk = bk.bcd(x, u0, v0, num_iters=ITERS, bounds=bounds)
            uk2, vk2 = bk.bcd(x, u0, v0, num_iters=ITERS, bounds=bounds)
            u1, v1 = bk.bcd(x[:1].contiguous(), u0[:1], v0[:1], num_iters=ITERS, bounds=bounds)
            ur, vr = bk.bcd_reference(x, u0, v0, num_iters=ITERS, bounds=bounds)
            torch.cuda.synchronize()
            lo, hi = bounds
            for f in (uk, vk):
                check(bool(torch.all(f == torch.round(f))), f"{shape}: non-integer factor")
                check(float(f.min()) >= lo and float(f.max()) <= hi, f"{shape}: factor outside {bounds}")
            loss_k = float(bcd_mod.qmf_loss(x, uk, vk).mean())
            loss_r = float(bcd_mod.qmf_loss(x, ur, vr).mean())
            eq_u = float((uk == ur).float().mean())
            eq_v = float((vk == vr).float().mean())
            check(abs(loss_k - loss_r) < 2e-3, f"{shape}: loss {loss_k} vs plain {loss_r}")
            check(eq_u > 0.85 and eq_v > 0.85, f"{shape}: equal share U {eq_u} V {eq_v}")
            check(torch.equal(uk, uk2) and torch.equal(vk, vk2), f"{shape}: two launches differ")
            check(torch.equal(uk[:1], u1) and torch.equal(vk[:1], v1), f"{shape}: image 0 depends on the batch")
            err = max(float((uk - ur).abs().max()), float((vk - vr).abs().max()))
            if bounds != BOUNDS:
                print(f"kernel {shape} bounds {bounds}: ok, loss {loss_k:.6f} vs plain {loss_r:.6f}, "
                      f"equal U {eq_u:.5f} V {eq_v:.5f}", flush=True)
                continue
            big = b * m * n > 10_000_000
            ms = cuda_ms(lambda: bk.bcd(x, u0, v0, num_iters=ITERS, bounds=bounds), 3 if big else 10)
            plain_ms = cuda_ms(lambda: bk.bcd_reference(x, u0, v0, num_iters=ITERS, bounds=bounds), 2 if big else 3)
            bound_ms, bound_by = bcd_bound_ms(b, m, n, r, ITERS)
            tile, smem_mode, smem = bk.KERNEL.plan(m, n, r)
            per_shape[shape] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, err=err)
            print(f"kernel {shape}: ok, loss {loss_k:.6f} vs plain {loss_r:.6f}, equal U {eq_u:.5f} "
                  f"V {eq_v:.5f}, max|diff| {err:g}; {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}); tile {tile} rows, "
                  f"{'shared' if smem_mode else 'global'} state, {smem} B smem", flush=True)
    return per_shape


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

    bk.KERNEL.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = lt.sharded_qmf_encode_batch(images, quality=10, device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = bk.KERNEL.launches
    check(launches == 2, f"main path launched the kernel {launches} times, expected 2 (Y, Cb+Cr)")
    print(f"main path: {launches} kernel launches in one encode of {b} images (first encode {first_s:.3f} s)")

    enc_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = lt.sharded_qmf_encode_batch(images, quality=10, device="cuda")
        enc_s.append(time.perf_counter() - t0)
    check(again == streams, "batched encode is not deterministic")

    fn, metadata = lt.build_sharded_encoder("cuda", (h, w), quality=10)
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

    enc_best, dec_best = min(enc_s), min(dec_s)
    print(f"main path: PSNR mean {p_kernel.mean():.4f} dB (min {p_kernel.min():.4f}); plain-BCD encode "
          f"max |dPSNR| {worst:.6f} dB, {same}/{b} streams byte-identical")
    print(f"main path [{label}]: encode {mpix / enc_best:.3f} Mpix/s ({enc_best * 1e3:.2f} ms per batch, "
          f"device part {device_ms:.3f} ms); decode {mpix / dec_best:.3f} Mpix/s ({dec_best * 1e3:.2f} ms)")
    print(f"main path [{label}]: of the {device_ms:.3f} ms device part, front end (color, chroma "
          f"downsample, pad, patchify) {front_ms:.3f} ms, init (Grams + eigh of {b + 2 * b} 64x64 matrices + "
          f"signs) {init_ms:.3f} ms; host part (fetch + zlib + framing) {enc_best * 1e3 - device_ms:.2f} ms")
    return dict(launches=launches, enc_ms=enc_best * 1e3, device_ms=device_ms)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {' '.join(bk.NVCC_FLAGS)})")
    print("\n".join(line for line in bk.KERNEL.build_log.splitlines() if "registers" in line or "spill" in line))

    per_shape = phase_kernel(torch, bk, bcd_mod, args.seed)
    main_run = phase_main_path(torch, lt, bk, args.seed, label)
    kernel_ms = sum(per_shape[s]["ms"] for s in MAIN_SHAPES)
    print(f"main path [{label}]: BCD kernel {kernel_ms:.3f} ms of the {main_run['device_ms']:.3f} ms device part "
          f"({100 * kernel_ms / main_run['device_ms']:.1f}%) and of the {main_run['enc_ms']:.2f} ms encode "
          f"({100 * kernel_ms / main_run['enc_ms']:.1f}%), from the phase-3 times at the same shapes")
    phase_variants(torch, lt, args.seed)

    entry = {
        "name": "bcd",
        "route": "cuda",
        "source": "lrf_tpu_torch/csrc/bcd.cu",
        "replaces": "lrf_tpu/ops/bcd_pallas.py:519 (K1, K2), lrf_tpu/ops/bcd_pallas.py:722 (K3)",
        "launches": main_run["launches"],
        "max_abs_err": max(per_shape[s]["err"] for s in MAIN_SHAPES),
        "ms": kernel_ms,
        "plain_ms": sum(per_shape[s]["plain_ms"] for s in MAIN_SHAPES),
        "bound_ms": sum(per_shape[s]["bound_ms"] for s in MAIN_SHAPES),
        "bound_by": per_shape[MAIN_SHAPES[0]]["bound_by"],
        "library_ms": None,
        "shapes": [list(s) for s in MAIN_SHAPES],
        "card": label,
    }
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(label)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
