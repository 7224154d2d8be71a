"""Test images for the port's tests: crops of the repo's own PNGs.

`experiments/data/demo/kodim01.png` and `experiments/data/local7/*.png`,
read directly (the `kodim01` fixture reads a reference checkout that is
not part of this repo).
"""

import glob
import os

import numpy as np
from PIL import Image

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments", "data")


def load(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB")).transpose(2, 0, 1)


def kodim01() -> np.ndarray:
    return load(os.path.join(DATA, "demo", "kodim01.png"))


def photos(b: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """`(b, 3, h, w)` uint8: crops at numpy-seeded offsets, image i from
    kodim01 when i is even and from the local7 PNGs in turn when odd."""
    rng = np.random.default_rng(seed)
    others = [load(p) for p in sorted(glob.glob(os.path.join(DATA, "local7", "*.png")))]
    base = kodim01()
    out = np.empty((b, 3, h, w), np.uint8)
    for i in range(b):
        src = base if i % 2 == 0 else others[(i // 2) % len(others)]
        top = int(rng.integers(0, src.shape[1] - h + 1))
        left = int(rng.integers(0, src.shape[2] - w + 1))
        out[i] = src[:, top : top + h, left : left + w]
    return out
