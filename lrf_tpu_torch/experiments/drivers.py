"""The comparison and ablation grids, one `eval_image` each.

Port of `experiments/comparison/eval.py` and `experiments/ablation_*/eval.py`,
with their exact grids and overrides:

- comparison: JPEG quality 0..74, SVD linspace(0, 5, 30) (RGB, 8x8
  patches), QMF linspace(0, 40, 80) in the canonical configuration;
- bounds: QMF with bounds (-8, 7), (-16, 15), (-32, 31) and (-128, 127);
- numiters: QMF with 0, 1, 2, 5 and 10 BCD sweeps;
- patchsize: QMF with 4x4, 8x8, 16x16 and 32x32 patches and with none
  (recorded as `patch_size=None`, so its rows never merge into the 8x8
  group);
- colorspace: QMF in RGB (linspace(0, 10, 50)) and in YCbCr with 4:2:0
  chroma (the canonical sweep).

Each `eval_image(image, image_id, device)` returns the image's rows.
"""

from __future__ import annotations

import numpy as np

from lrf_tpu_torch.experiments.common import sweep_jpeg, sweep_qmf, sweep_svd
from lrf_tpu_torch.models.qmf import qmf_decode, qmf_encode
from lrf_tpu_torch.utils.eval import eval_compression

__all__ = ["DRIVERS", "comparison", "bounds", "numiters", "patchsize", "colorspace", "rgb_qmf_params"]


def comparison(image, image_id: str, device="cuda") -> list[dict]:
    results = []
    results.extend(sweep_jpeg(image, image_id, device=device))
    results.extend(sweep_svd(image, image_id, device=device))
    results.extend(sweep_qmf(image, image_id, device=device))
    return results


def bounds(image, image_id: str, device="cuda") -> list[dict]:
    results = []
    for b in [(-8, 7), (-16, 15), (-32, 31), (-128, 127)]:
        results.extend(sweep_qmf(image, image_id, device=device, bounds=b))
    return results


def numiters(image, image_id: str, device="cuda") -> list[dict]:
    results = []
    for num_iters in [0, 1, 2, 5, 10]:
        results.extend(sweep_qmf(image, image_id, device=device, num_iters=num_iters))
    return results


def patchsize(image, image_id: str, device="cuda") -> list[dict]:
    results = []
    for patch_size, patch in [(4, True), (8, True), (16, True), (32, True), (None, False)]:
        overrides = {"patch": patch, "patch_size": (patch_size, patch_size) if patch else None}
        results.extend(sweep_qmf(image, image_id, device=device, **overrides))
    return results


def rgb_qmf_params(quality: float) -> dict:
    """The color-space ablation's RGB configuration at one quality."""
    return {
        "color_space": "RGB",
        "quality": float(quality),
        "patch": True,
        "patch_size": (8, 8),
        "bounds": (-16, 15),
        "dtype": np.int8,
        "num_iters": 10,
    }


def colorspace(image, image_id: str, device="cuda") -> list[dict]:
    results = []
    for quality in np.linspace(0.0, 10, 50):
        params = rgb_qmf_params(quality)
        log = eval_compression(image, qmf_encode, qmf_decode, device=device, **params)
        results.append({"data": image_id, "method": "QMF", **params, **log})
    results.extend(sweep_qmf(image, image_id, device=device))
    return results


# name -> (eval_image, default save directory, description)
DRIVERS = {
    "comparison": (comparison, "comparison", "Compare JPEG, SVD and QMF over a dataset."),
    "bounds": (bounds, "ablation_bounds", "QMF bounds ablation."),
    "numiters": (numiters, "ablation_numiters", "QMF num_iters ablation."),
    "patchsize": (patchsize, "ablation_patchsize", "QMF patch-size ablation."),
    "colorspace": (colorspace, "ablation_colorspace", "QMF color-space ablation."),
}
