"""Spatial resampling: adaptive area pooling and nearest-neighbour resize.

PyTorch port of `lrf_tpu/ops/resample.py:24-112`, with its aliases
`chroma_downsampling` and `chroma_upsampling`. Index and window rules
are computed on the host with numpy, exactly as the JAX package does:

- area pooling is an exact reshape-mean for divisible sizes; otherwise
  output i averages the window ``[floor(i*in/out), ceil((i+1)*in/out))``
  with the weight ``float32(1 / (e - s))``;
- nearest resize picks ``src = floor(dst * in / out)``.

Where the size does not divide, the pool sums the window's rounded products
``x[s + k] * w`` in tap order (k = 0, 1, ...) with elementwise ops:
`index_select` per tap, and `torch.where` to leave the sum alone past the
end of a window shorter than the longest. The JAX package contracts a
dense `(out, in)` weight matrix with `einsum`. As a matmul that is cuBLAS
on the card and another BLAS on the CPU, and the two summed the windows in
other orders: the card's chroma differed from the CPU's in 3.4-4.4% of
entries on the odd-size photographs china.png and clic_flower_fig.png. The
elementwise sum gives the same bits on every device and whatever the batch.
Tap order is also the order XLA's CPU dot takes at most shapes: it equals
the JAX package's bits in every entry at widths 93, 333, 401, 455, 517 and
663, where the matmul did in 73-79%; at widths 61 and 425-429 XLA takes
another order and 78-80% are equal (`tests/torch_parity_report.py pool`,
`tests/test_torch_frontend_parity.py`).

`torch.nn.functional.interpolate` is deliberately not used: its float
index arithmetic can pick other source pixels.
"""

from __future__ import annotations

import numpy as np
import torch


def _area_pool_1d(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """Adaptive average pool along one axis."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if in_size % out_size == 0:
        k = in_size // out_size
        new_shape = x.shape[:axis] + (out_size, k) + x.shape[axis + 1 :]
        return torch.mean(x.reshape(new_shape), dim=axis + 1)
    starts = np.floor(np.arange(out_size) * in_size / out_size).astype(np.int64)
    ends = np.ceil((np.arange(out_size) + 1) * in_size / out_size).astype(np.int64)
    lengths = ends - starts
    # the JAX package's weights: 1 / (e - s) rounded to float32
    weights = (1.0 / lengths).astype(np.float32)
    bcast = [1] * x.ndim
    bcast[axis] = out_size
    w = torch.from_numpy(weights).reshape(bcast).to(x.device)

    def term(k: int) -> torch.Tensor:  # tap k of every window (clamped past the input's end)
        taps = torch.from_numpy(np.minimum(starts + k, in_size - 1)).to(x.device)
        return torch.index_select(x, axis, taps) * w

    pooled = term(0)
    for k in range(1, int(lengths.max())):
        live = torch.from_numpy(k < lengths).reshape(bcast).to(x.device)
        pooled = torch.where(live, pooled + term(k), pooled)
    return pooled


def area_resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Adaptive average-pool resize of `(..., H, W)` to `size`."""
    x = _area_pool_1d(x.to(torch.float32), size[0], axis=x.ndim - 2)
    return _area_pool_1d(x, size[1], axis=x.ndim - 1)


def nearest_resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of `(..., H, W)`: ``src = floor(dst * in / out)``."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = size
    rows = np.floor(np.arange(h_out) * h_in / h_out).astype(np.int64)
    cols = np.floor(np.arange(w_out) * w_in / w_out).astype(np.int64)
    x = torch.index_select(x, x.ndim - 2, torch.from_numpy(rows).to(x.device))
    return torch.index_select(x, x.ndim - 1, torch.from_numpy(cols).to(x.device))


def scaled_size(in_size: tuple[int, int], scale_factor: tuple[float, float]) -> tuple[int, int]:
    """Output size rule of `interpolate(scale_factor=...)`: floor(H*s)."""
    return (
        int(np.floor(in_size[0] * scale_factor[0])),
        int(np.floor(in_size[1] * scale_factor[1])),
    )


def chroma_downsample(
    ycbcr: torch.Tensor, scale_factor: tuple[float, float] = (0.5, 0.5)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split `(..., 3, H, W)` YCbCr into (Y, Cb, Cr), chroma area-downsampled.

    Each channel keeps a leading singleton channel dim.
    """
    h, w = ycbcr.shape[-2], ycbcr.shape[-1]
    out_size = scaled_size((h, w), scale_factor)
    y = ycbcr[..., 0:1, :, :]
    cb = area_resize(ycbcr[..., 1:2, :, :], out_size)
    cr = area_resize(ycbcr[..., 2:3, :, :], out_size)
    return y, cb, cr


def chroma_upsample(
    ycbcr: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    size: tuple[int, int],
    mode: str = "nearest",
) -> torch.Tensor:
    """Upsample Cb/Cr to `size` and restack into `(..., 3, H, W)`."""
    y, cb, cr = ycbcr
    resize = nearest_resize if mode == "nearest" else area_resize
    return torch.cat([y, resize(cb, size), resize(cr, size)], dim=-3)


# The reference's names.
chroma_downsampling = chroma_downsample
chroma_upsampling = chroma_upsample
