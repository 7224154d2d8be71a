"""The comparison that decides a run's `correct`.

Encode cells: the reference parses every stream of each pool batch's first
answer, inflates it with zlib, and encodes the same input images itself;
per image, the share of factor entries (all six factors) that differ from
its own is the reading. A stream it cannot read, or whose metadata is not
the configuration's, counts as unreadable. Decode cells: the reference
decodes the same streams itself; the share of pixel values apart from the
program's and the widest gap are the readings, and the streams it decodes,
which the program wrote in set-up, are held to the encode cells' readings
against the same input images. The harness adds `unlike_first`: answers of
the window, a sample drawn from the seed, that differ from their pool
batch's first answer (the one checked here), byte for byte or pixel for
pixel.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import codec


def _codec_args(cfg: dict) -> dict:
    return dict(bounds=tuple(cfg["bounds"]), scale=tuple(cfg["scale_factor"]), patch=tuple(cfg["patch_size"]))


def parse_batch(streams, cfg: dict, size):
    """`(factors, unreadable)`: the six `(B, ., R)` int8 factors of a batch
    of streams (None where the batch has an unreadable stream) and the
    count of unreadable streams."""
    args = _codec_args(cfg)
    want = codec.metadata(size, cfg["quality"], args["bounds"], args["scale"], args["patch"])
    parsed, bad = [], 0
    for s in streams:
        try:
            md, f = codec.parse_stream(s)
        except ValueError:
            bad += 1
            continue
        if md != want:
            bad += 1
            continue
        parsed.append(f)
    if bad or not parsed:
        return None, bad
    shapes = {tuple(a.shape for a in f) for f in parsed}
    if len(shapes) != 1:
        return None, len(streams)
    return [np.stack([f[k] for f in parsed]) for k in range(6)], 0


def reference_factors(images: np.ndarray, cfg: dict, device, precision: str = "float32", chunk: int = 16):
    """The reference's six factors of a batch, `chunk` images at a time."""
    args = _codec_args(cfg)
    parts = [codec.encode_factors(images[i:i + chunk], cfg["quality"], args["bounds"], cfg["num_iters"], device,
                                  precision, args["scale"], args["patch"]) for i in range(0, len(images), chunk)]
    return [np.concatenate([p[k] for p in parts]) for k in range(6)]


def apart_per_image(got, want) -> np.ndarray:
    """Share of each image's factor entries (all six factors) that differ."""
    diff = sum((a != b).reshape(len(a), -1).sum(axis=1) for a, b in zip(got, want))
    total = sum(a[0].size for a in want)
    return diff / total


def encode_numbers(answers: dict, pool: list, cfg: dict, device, chunk: int = 16) -> dict:
    """`unreadable`, `apart_mean` and `apart_worst` over the first answer of
    every pool batch (`answers[j]`, a list of streams for `pool[j]`)."""
    unreadable, shares = 0, []
    for j, streams in sorted(answers.items()):
        images = pool[j]
        if len(streams) != len(images):
            unreadable += len(images)
            continue
        got, bad = parse_batch(streams, cfg, images.shape[-2:])
        unreadable += bad
        if got is None:
            continue
        shares.append(apart_per_image(got, reference_factors(images, cfg, device, chunk=chunk)))
    shares = np.concatenate(shares) if shares else np.ones(1)
    return {"unreadable": unreadable, "apart_mean": float(shares.mean()), "apart_worst": float(shares.max())}


def decode_numbers(answers: dict, streams: list, cfg: dict, device, precision: str = "float32") -> dict:
    """`unreadable`, `pix_apart` (share of pixel values apart) and
    `pix_diff_max` over the first answer of every pool batch (`answers[j]`,
    the pixels decoded from `streams[j]`)."""
    unreadable, apart, total, widest = 0, 0, 0, 0
    for j, pixels in sorted(answers.items()):
        size = tuple(pixels.shape[-2:])
        got, bad = parse_batch(streams[j], cfg, size)
        unreadable += bad
        if got is None:
            continue
        md = codec.metadata(size, cfg["quality"], tuple(cfg["bounds"]), tuple(cfg["scale_factor"]),
                            tuple(cfg["patch_size"]))
        want = codec.decode(md, got, device, precision)
        if want.shape != pixels.shape:
            unreadable += len(streams[j])
            continue
        gap = np.abs(want.astype(np.int16) - pixels.astype(np.int16))
        apart += int(np.count_nonzero(gap))
        total += gap.size
        widest = max(widest, int(gap.max()))
    return {"unreadable": unreadable, "pix_apart": apart / total if total else 1.0, "pix_diff_max": widest}


def decode_cell_numbers(answers: dict, streams: list, pool: list, cfg: dict, device, precision: str = "float32",
                        chunk: int = 16) -> dict:
    """A decode cell's numbers: `decode_numbers` over the pixels, and
    `encode_numbers`' `apart_mean` and `apart_worst` over the streams it
    decoded (written by the program in set-up from `pool`), their
    unreadable streams counted once."""
    numbers = decode_numbers(answers, streams, cfg, device, precision)
    enc = encode_numbers(dict(enumerate(streams)), pool, cfg, device, chunk)
    numbers["apart_mean"], numbers["apart_worst"] = enc["apart_mean"], enc["apart_worst"]
    return numbers


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """`(correct, checks)`: each number beside its limit; correct when every
    number is at or under its limit."""
    checks = {name: {"value": value, "limit": limits[name]} for name, value in numbers.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
