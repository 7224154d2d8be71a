"""Sweep grids, dataset iteration and results files.

Port of `experiments/common.py`: the same grids, the same row schema
("data", "method", the codec's parameters, the six metric columns of
`eval_compression` and "platform"; on the card also "encoding device time
(ms)") and the same `{prefix}_results.json` file, so stored results of
either package load and plot alike. Every sweep takes `device=` and runs
the port's codecs through the port's `eval_compression` there.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Iterable, Optional

import numpy as np

from lrf_tpu_torch.models.pil import pil_decode, pil_encode
from lrf_tpu_torch.models.qmf import qmf_decode, qmf_encode
from lrf_tpu_torch.models.svd import svd_decode, svd_encode
from lrf_tpu_torch.utils.config import read_config, save_config
from lrf_tpu_torch.utils.eval import eval_compression, read_image

__all__ = [
    "dataset_images",
    "sweep_jpeg",
    "sweep_svd",
    "sweep_qmf",
    "qmf_params",
    "run_over_dataset",
    "add_driver_args",
    "resolve_args",
    "default_argparser",
]


def dataset_images(data_dir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(data_dir, "*.png")))


def _jpeg_encode(image, device=None, **kwargs) -> bytes:
    return pil_encode(image, **kwargs)  # PIL codes on the host


def _jpeg_decode(encoded: bytes, device=None) -> np.ndarray:
    return pil_decode(encoded)


def sweep_jpeg(image, image_id: str, qualities: Iterable[int] = range(0, 75), device="cuda") -> list[dict]:
    """JPEG baseline sweep; PSNR and SSIM are computed on `device`."""
    results = []
    for quality in qualities:
        params = {"quality": int(quality)}
        log = eval_compression(image, _jpeg_encode, _jpeg_decode, device=device, format="JPEG", **params)
        results.append({"data": image_id, "method": "JPEG", **params, **log})
    return results


def sweep_svd(image, image_id: str, qualities: Optional[Iterable[float]] = None, device="cuda") -> list[dict]:
    """SVD sweep on the RGB + 8x8 patch path, quality linspace(0, 5, 30)."""
    qualities = np.linspace(0.0, 5, 30) if qualities is None else qualities
    results = []
    for quality in qualities:
        params = {"color_space": "RGB", "quality": float(quality), "patch": True, "patch_size": (8, 8)}
        log = eval_compression(image, svd_encode, svd_decode, device=device, **params)
        results.append({"data": image_id, "method": "SVD", **params, **log})
    return results


def qmf_params(quality: float, **overrides) -> dict:
    """The canonical QMF configuration at one quality (Y at q, Cb and Cr at
    q / 2), with `overrides` applied."""
    params = {
        "color_space": "YCbCr",
        "scale_factor": (0.5, 0.5),
        "quality": (float(quality), float(quality) / 2, float(quality) / 2),
        "patch": True,
        "patch_size": (8, 8),
        "bounds": (-16, 15),
        "dtype": np.int8,
        "num_iters": 10,
    }
    params.update(overrides)
    return params


def sweep_qmf(
    image, image_id: str, qualities: Optional[Iterable[float]] = None, device="cuda", **overrides
) -> list[dict]:
    """QMF sweep of the canonical configuration, quality linspace(0, 40, 80)."""
    qualities = np.linspace(0, 40, 80) if qualities is None else qualities
    results = []
    for quality in qualities:
        params = qmf_params(quality, **overrides)
        log = eval_compression(image, qmf_encode, qmf_decode, device=device, **params)
        results.append({"data": image_id, "method": "QMF", **params, **log})
    return results


def run_over_dataset(
    data_dir: str,
    per_image: Callable[[np.ndarray, str], list[dict]],
    save_dir: str,
    prefix: str,
    verbose: bool = True,
    resume: bool = True,
) -> list[dict]:
    """`per_image(image, image_id)` over every PNG of `data_dir`, in name order.

    The results file is rewritten atomically after every image; with
    `resume`, the images whose rows it already holds are skipped.
    """
    results: list[dict] = []
    done: set[str] = set()
    results_path = os.path.join(save_dir, f"{prefix}_results.json")
    if resume and os.path.exists(results_path):
        results = read_config(results_path)
        done = {row["data"] for row in results}
        if verbose and done:
            print(f"resuming: {len(done)} images already swept", flush=True)

    for path in dataset_images(data_dir):
        image_id = os.path.basename(path)
        if image_id in done:
            continue
        rows = per_image(read_image(path), image_id)
        results.extend(rows)
        save_config(results, save_dir=save_dir, prefix=prefix)  # checkpoint
        if verbose:
            print(f"image {image_id}: {len(rows)} rows", flush=True)
    save_config(results, save_dir=save_dir, prefix=prefix)
    return results


def add_driver_args(parser, default_save_dir: str):
    """The drivers' flags: `--data` (a dataset name), `--data_dir` (default
    `experiments/data/<data>`, from the working directory), `--save_dir`,
    `--prefix` (default the dataset name) and `--device` (default cuda)."""
    parser.add_argument("--data", type=str, default="kodak")
    parser.add_argument("--data_dir", type=str, nargs="?")
    parser.add_argument("--save_dir", type=str, default=default_save_dir)
    parser.add_argument("--prefix", type=str, nargs="?")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


def resolve_args(args):
    """Fill in the defaults of `--data_dir` and `--prefix` from `--data`."""
    if args.data_dir is None:
        args.data_dir = os.path.join("experiments", "data", args.data)
    if args.prefix is None:
        args.prefix = args.data
    return args


def default_argparser(description: str, default_save_dir: str, argv=None):
    """Parse the drivers' flags from `argv` (default: the command line)."""
    import argparse

    parser = add_driver_args(argparse.ArgumentParser(description=description), default_save_dir)
    return resolve_args(parser.parse_args(argv))
