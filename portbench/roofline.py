"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet) and the least time of
the BCD sweeps, frozen here so that the yardstick stays the same whatever
kernel runs them."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores; the sweeps' FMAs are CUDA-core work


def bcd_bound_ms(b: int, m: int, n: int, r: int, iters: int) -> tuple[float, str]:
    """Least time for `iters` BCD sweeps of a `(b, m, n)` stack at rank `r`:
    each input read once and each output written once, against the f32
    flops of the sweeps, 4(MNR + MR^2 + NR^2) per sweep and image."""
    nbytes = 4 * b * (m * n + 2 * (m * r + n * r))
    flops = iters * b * 4 * (m * n * r + m * r * r + n * r * r)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
