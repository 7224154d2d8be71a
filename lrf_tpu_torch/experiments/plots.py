"""The figures of the sweeps: RD curves, ablation curves and the collage.

Ports of `experiments/comparison/plot.py`, `experiments/ablation_plot.py`
and `experiments/examples/collage.py`, over the port's `Plot`,
`vis_collage` and codecs. Drawing needs matplotlib (and seaborn and
pandas for the curves); the collage's sweeps run on `device`.
"""

from __future__ import annotations

import os

import numpy as np

from lrf_tpu_torch.experiments.common import _jpeg_decode, _jpeg_encode, qmf_params
from lrf_tpu_torch.models.qmf import qmf_decode, qmf_encode
from lrf_tpu_torch.models.svd import svd_decode, svd_encode
from lrf_tpu_torch.utils.config import read_config
from lrf_tpu_torch.utils.eval import eval_compression, read_image
from lrf_tpu_torch.utils.plotting import Plot
from lrf_tpu_torch.utils.viz import vis_collage

__all__ = ["COMPARISON_METRICS", "BPP_GRID", "plot_comparison", "plot_ablation", "collage_rows", "collage"]

COMPARISON_METRICS = ["PSNR (dB)", "SSIM", "encoding time (ms)", "decoding time (ms)"]
BPP_GRID = np.linspace(0.05, 0.5, 19)


def _agg_backend() -> None:
    import matplotlib

    matplotlib.use("Agg")


def plot_comparison(results: str, save_dir: str = ".", prefix: str = "comparison") -> None:
    """LOESS-interpolated curves of each metric against bpp, one figure per
    metric (`{prefix}_<metric>.pdf`), per method with standard-error bands."""
    _agg_backend()
    rows = read_config(results)
    for metric in COMPARISON_METRICS:
        plot = Plot(rows)
        plot.interpolate(x="bit rate (bpp)", y=metric, x_values=BPP_GRID)
        plot.plot(x="bit rate (bpp)", y=metric, xlim=(0.05, 0.5), legend_labels=("QMF", "JPEG", "SVD"))
        plot.save(save_dir=save_dir, prefix=prefix)


def plot_ablation(results: str, groupby: str, metric: str = "PSNR (dB)", save_dir: str = ".",
                  prefix: str = "ablation"):
    """RD curves grouped by the ablated parameter column `groupby`
    (`{prefix}_<metric>.pdf`)."""
    _agg_backend()
    rows = read_config(results)
    for row in rows:  # list-valued knobs (bounds) as tuples' text, for grouping
        if isinstance(row.get(groupby), list):
            row[groupby] = str(tuple(row[groupby]))
    plot = Plot(rows)
    plot.interpolate(x="bit rate (bpp)", y=metric, x_values=BPP_GRID, groupby=("data", groupby))
    plot.plot(x="bit rate (bpp)", y=metric, groupby=groupby, xlim=(0.05, 0.5))
    plot.save(save_dir=save_dir, prefix=prefix)


def collage_rows(image, device="cuda") -> list[dict]:
    """JPEG, SVD and QMF sweeps of one image that keep the reconstructions."""
    rows = []
    for quality in range(0, 60, 3):
        log = eval_compression(image, _jpeg_encode, _jpeg_decode, reconstruct=True, device=device,
                               format="JPEG", quality=int(quality))
        rows.append({"method": "JPEG", **log})
    for quality in np.linspace(0.0, 4, 14):
        log = eval_compression(image, svd_encode, svd_decode, reconstruct=True, device=device,
                               color_space="RGB", quality=float(quality), patch=True, patch_size=(8, 8))
        rows.append({"method": "SVD", **log})
    for quality in np.linspace(0, 30, 16):
        log = eval_compression(image, qmf_encode, qmf_decode, reconstruct=True, device=device,
                               **qmf_params(quality))
        rows.append({"method": "QMF", **log})
    return rows


def collage(image_path: str, bpps=(0.1, 0.2, 0.3), out: str = "collage", device="cuda") -> str:
    """The method x bpp collage of one image (and each cell's own image)
    under `out`; the collage's path."""
    _agg_backend()
    rows = collage_rows(read_image(image_path), device=device)
    prefix = os.path.splitext(os.path.basename(image_path))[0]
    vis_collage(rows, list(bpps), save_dir=out, prefix=prefix)
    return os.path.join(out, f"{prefix}_collage.pdf")
