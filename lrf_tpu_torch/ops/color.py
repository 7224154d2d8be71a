"""Color-space transforms (full-range BT.601 RGB <-> YCbCr).

PyTorch port of `lrf_tpu/ops/color.py:15-47`: the same constants and the
same `(..., 3, H, W)` layout. The 3x3 mix is written as three explicit
multiply-adds per output channel, so the result does not depend on the
batch shape or on how a matmul library orders a K=3 contraction.
"""

from __future__ import annotations

import torch

_RGB_TO_YCBCR = (
    (0.299, 0.587, 0.114),
    (-0.168736, -0.331264, 0.5),
    (0.5, -0.418688, -0.081312),
)
_YCBCR_TO_RGB = (
    (1.0, 0.0, 1.40200),
    (1.0, -0.344136, -0.714136),
    (1.0, 1.77200, 0.0),
)
_YCBCR_OFFSET = (0.0, 128.0, 128.0)


def _mix(m, x: torch.Tensor) -> torch.Tensor:
    """`einsum("ij,...jhw->...ihw", m, x)` in float32, as explicit sums."""
    c = [x[..., j, :, :] for j in range(3)]
    rows = []
    for i in range(3):
        coef = [torch.tensor(m[i][j], dtype=torch.float32) for j in range(3)]
        rows.append(c[0] * coef[0] + c[1] * coef[1] + c[2] * coef[2])
    return torch.stack(rows, dim=-3)


def _offset(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_YCBCR_OFFSET, dtype=torch.float32, device=x.device).reshape(3, 1, 1)


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """RGB `(..., 3, H, W)` -> full-range YCbCr: ``offset + M @ rgb``."""
    rgb = rgb.to(torch.float32)
    return _offset(rgb) + _mix(_RGB_TO_YCBCR, rgb)


def ycbcr_to_rgb(ycbcr: torch.Tensor) -> torch.Tensor:
    """Full-range YCbCr `(..., 3, H, W)` -> RGB: ``M_inv @ (ycbcr - offset)``."""
    ycbcr = ycbcr.to(torch.float32)
    return _mix(_YCBCR_TO_RGB, ycbcr - _offset(ycbcr))
