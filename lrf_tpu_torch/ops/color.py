"""Color-space transforms (full-range BT.601 RGB <-> YCbCr).

PyTorch port of `lrf_tpu/ops/color.py:15-47`: the same constants and the
same `(..., 3, H, W)` layout. The JAX package's 3x3 mix is an einsum, which
XLA's CPU `dot` computes per output channel as the chain
``fma(c2, m2, fma(c1, m1, c0 * m0))`` with float32 constants; the offset is
added after. `_mix` computes that chain in the same order, so its bits are
the JAX package's. Each fused step is formed in float64 and rounded to
float32 once: a float32 x float32 product is exact in float64, and each
step is its own elementwise op, so no compiler contracts or reorders it and
the card gives the CPU's bits. For integer inputs (the codec's RGB) every
float64 sum is exact too, so each step is rounded once, as an FMA is.
Neither `torch.addcmul` nor a fused expression is used: whether those
become FMAs differs between devices.
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


def _coef(value: float) -> float:
    """The float32 value of a table constant, as a Python float."""
    return float(torch.tensor(value, dtype=torch.float32))


def _mix(m, x: torch.Tensor) -> torch.Tensor:
    """`einsum("ij,...jhw->...ihw", m, x)` in float32, in XLA's CPU order:
    per output channel ``fma(c2, m2, fma(c1, m1, c0 * m0))``, each step
    rounded to float32 from float64."""
    c = [x[..., j, :, :] for j in range(3)]
    wide = [cj.to(torch.float64) for cj in c]
    rows = []
    for i in range(3):
        acc = c[0] * _coef(m[i][0])
        for j in (1, 2):
            acc = (wide[j] * _coef(m[i][j]) + acc.to(torch.float64)).to(torch.float32)
        rows.append(acc)
    return torch.stack(rows, dim=-3)


def _offset(x: torch.Tensor) -> torch.Tensor:
    """The `(3, 1, 1)` float32 offset on x's device, filled there: a host
    tensor sent to a card without `non_blocking` first waits for all the
    work queued on the stream, which would stall the encode pipeline."""
    offset = torch.empty((3, 1, 1), dtype=torch.float32, device=x.device)
    for i, value in enumerate(_YCBCR_OFFSET):
        offset[i] = value
    return offset


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """RGB `(..., 3, H, W)` -> full-range YCbCr: ``offset + M @ rgb``."""
    rgb = rgb.to(torch.float32)
    return _offset(rgb) + _mix(_RGB_TO_YCBCR, rgb)


def ycbcr_to_rgb(ycbcr: torch.Tensor) -> torch.Tensor:
    """Full-range YCbCr `(..., 3, H, W)` -> RGB: ``M_inv @ (ycbcr - offset)``."""
    ycbcr = ycbcr.to(torch.float32)
    return _mix(_YCBCR_TO_RGB, ycbcr - _offset(ycbcr))
