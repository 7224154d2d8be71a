"""Image and factor-map visualization helpers.

Port of `lrf_tpu/utils/viz.py`: single-image display, batch and
factor-map grids (with `depatchify_uv`, to inspect QMF components), the
two normalizers, and the method x bpp qualitative collage.

`zscore_normalize` and `minmax_normalize` are tensor functions: they take
tensors or arrays and compute in float32 on the input's device (arrays on
the CPU). The `vis_*` helpers take tensors (on any device) or arrays, move
them to the host themselves, and draw with matplotlib, imported when they
are called.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from lrf_tpu_torch.utils.transfer import to_host

__all__ = [
    "vis_image",
    "vis_image_batch",
    "vis_collage",
    "zscore_normalize",
    "minmax_normalize",
]


def _float_tensor(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(torch.float32)


def _dims(axis) -> tuple[int, ...]:
    return (axis,) if isinstance(axis, int) else tuple(axis)


def zscore_normalize(x, axis=(-2, -1), eps: float = 1e-8) -> torch.Tensor:
    """Z-score normalization over `axis`, sample standard deviation (ddof 1)."""
    x = _float_tensor(x)
    dims = _dims(axis)
    mean = x.mean(dim=dims, keepdim=True)
    std = x.std(dim=dims, correction=1, keepdim=True)
    return (x - mean) / (std + eps)


def minmax_normalize(x, axis=(-2, -1), eps: float = 1e-8) -> torch.Tensor:
    """Min-max normalization over `axis`."""
    x = _float_tensor(x)
    dims = _dims(axis)
    lo = x.amin(dim=dims, keepdim=True)
    hi = x.amax(dim=dims, keepdim=True)
    return (x - lo) / (hi - lo + eps)


def _host(x) -> np.ndarray:
    return to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def vis_image(
    image,
    title: Optional[str] = None,
    save_dir: Optional[str] = None,
    prefix: str = "",
    format: str = "pdf",
    **kwargs,
):
    """Display a `(C, H, W)` image, optionally saving it."""
    import matplotlib.pyplot as plt

    image = _host(image)
    if image.ndim != 3 or image.shape[0] not in (1, 3):
        raise ValueError("Image should have shape [C, H, W] with C being 1 or 3.")
    fig, ax = plt.subplots()
    ax.imshow(image.transpose(1, 2, 0).squeeze(), **kwargs)
    ax.axis("off")
    if title:
        ax.set_title(title)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fig.savefig(os.path.join(save_dir, f"{prefix}.{format.lower()}"), bbox_inches="tight", pad_inches=0)
    return fig, ax


def vis_image_batch(
    images,
    multi_channels: bool = True,
    grid_size=None,
    fig_size=None,
    title: Optional[str] = None,
    save_dir: Optional[str] = None,
    prefix: str = "",
    format: str = "pdf",
    **kwargs,
):
    """Grid display of a batch of images or factor maps.

    `images`: `(*batch, [C,] H, W)`; with `multi_channels` the channel dim
    is moved last for imshow. For QMF factor maps, e.g.
    ``vis_image_batch(minmax_normalize(u_map), multi_channels=False)``.
    """
    import matplotlib.pyplot as plt

    images = _host(images)
    shape = images.shape[-2:]
    if images.ndim == 2:
        images = images[None]
    if multi_channels:
        images = np.moveaxis(images, -3, -1)
        batch_dims = images.shape[:-3]
    else:
        batch_dims = images.shape[:-2]
    total = int(np.prod(batch_dims)) if batch_dims else 1

    if grid_size is None:
        num_cols = int(math.ceil(math.sqrt(total)))
        grid_size = (int(math.ceil(total / num_cols)), num_cols)
    elif isinstance(grid_size, int):
        grid_size = (grid_size, int(math.ceil(total / grid_size)))

    if fig_size is None:
        fig_h = grid_size[0] * shape[0]
        fig_w = grid_size[1] * shape[1]
        fig_size = (10 * fig_w / (fig_h + fig_w), 10 * fig_h / (fig_h + fig_w))

    fig, axs = plt.subplots(*grid_size, figsize=fig_size)
    axs = np.atleast_1d(axs).ravel()
    flat = images.reshape((total,) + images.shape[len(batch_dims):])
    for i in range(total):
        axs[i].imshow(flat[i].squeeze(), **kwargs)
        axs[i].axis("off")
    for ax in axs[total:]:
        ax.axis("off")
    if title:
        fig.suptitle(title)
    fig.subplots_adjust(
        wspace=0.2 * shape[0] / (shape[0] + shape[1]),
        hspace=0.2 * shape[1] / (shape[0] + shape[1]),
    )
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fig.savefig(os.path.join(save_dir, f"{prefix}.{format}".lower()), bbox_inches="tight", pad_inches=0)
    return fig, axs


def vis_collage(
    results: Sequence[dict],
    bpps: Sequence[float],
    save_dir: Optional[str] = None,
    prefix: str = "",
    format: str = "pdf",
):
    """Method x bpp qualitative grid.

    `results` rows need "method", "bit rate (bpp)" and "reconstructed"
    (from `eval_compression(..., reconstruct=True)`). For each bpp and
    method the row with the nearest bit rate is shown, titled with its
    bpp and, when present, its PSNR; with `save_dir` each cell is also
    written as an image of its own.
    """
    import matplotlib.pyplot as plt

    methods = sorted({r["method"] for r in results})
    fig, axs = plt.subplots(len(methods), len(bpps), figsize=(3 * len(bpps), 3 * len(methods)), squeeze=False)
    for i, method in enumerate(methods):
        rows = [r for r in results if r["method"] == method]
        for j, bpp in enumerate(bpps):
            row = min(rows, key=lambda r: abs(r["bit rate (bpp)"] - bpp))
            img = _host(row["reconstructed"])
            axs[i][j].imshow(img.transpose(1, 2, 0).squeeze())
            axs[i][j].axis("off")
            label = f"{method} @ {row['bit rate (bpp)']:.2f} bpp"
            if "PSNR (dB)" in row:
                label += f", {row['PSNR (dB)']:.2f} dB"
            axs[i][j].set_title(label, fontsize=8)
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                cell_name = f"{prefix}_{method}_bpp_{row['bit rate (bpp)']:.2f}.{format}"
                vfig, _ = vis_image(img)
                vfig.savefig(os.path.join(save_dir, cell_name.lower()), bbox_inches="tight", pad_inches=0)
                plt.close(vfig)
    fig.tight_layout()
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fig.savefig(os.path.join(save_dir, f"{prefix}_collage.{format}".lower()), bbox_inches="tight", pad_inches=0)
    return fig, axs
