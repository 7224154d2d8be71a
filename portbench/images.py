"""Stand-in photographs: the benchmark's input pixels, made from `--seed`.

A frozen copy of the repository's smoke-test loader, extended to any size:
each image is a center crop of one of the PNGs under `portbench/data/`,
reflect-tiled where the PNG is smaller, rolled and flipped by how often
that PNG has come round, plus Gaussian noise. The seed orders the crops
and draws the noise (on the run's device, in one call per batch), so every
seed gets the same set of crops and the same work.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

DATA = Path(__file__).resolve().parent / "data"


def _sources(names, size) -> list[np.ndarray]:
    from PIL import Image

    h, w = size
    out = []
    for name in names:
        img = np.asarray(Image.open(DATA / name).convert("RGB")).transpose(2, 0, 1)
        ph, pw = max(0, h - img.shape[1]), max(0, w - img.shape[2])
        out.append(np.pad(img, ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)), mode="reflect"))
    return out


def crops(names, size, count: int) -> np.ndarray:
    """`count` uint8 `(3, H, W)` crops: image g is PNG g mod n, rolled by
    (17k, 29k) and flipped by the bits of k = g div n."""
    sources = _sources(names, size)
    h, w = size
    out = np.empty((count, 3, h, w), np.uint8)
    for g in range(count):
        src = sources[g % len(sources)]
        k = g // len(sources)
        src = np.roll(src, (17 * k, 29 * k), axis=(1, 2))
        top, left = (src.shape[1] - h) // 2, (src.shape[2] - w) // 2
        img = src[:, top:top + h, left:left + w]
        if k & 1:
            img = img[:, :, ::-1]
        if k & 2:
            img = img[:, ::-1, :]
        out[g] = img
    return out


def make_pool(images: dict, size, batch: int, pool: int, seed: int, device) -> list[np.ndarray]:
    """`pool` distinct host batches of uint8 `(batch, 3, H, W)` images.

    `images` is the configuration's `images` entry: `sources` (PNG names)
    and `noise_sigma` (the noise's standard deviation in pixel levels)."""
    seed = seed % 2**63
    base = crops(images["sources"], size, batch * pool)
    base = base[np.random.default_rng(seed).permutation(len(base))]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for j in range(pool):
        x = torch.from_numpy(base[j * batch:(j + 1) * batch]).to(device)
        noise = torch.randn(x.shape, generator=gen, device=device) * float(images["noise_sigma"])
        out.append(torch.clamp(torch.round(x.to(torch.float32) + noise), 0, 255).to(torch.uint8).cpu().numpy())
    return out
