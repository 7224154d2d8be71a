"""Evaluation harness: per-image compression metrics with timing.

Port of `lrf_tpu/utils/eval.py`. `eval_compression` returns the keys of
the JAX package (and of the reference's `eval_compression`), so the same
plotting reads both. The encoder and decoder calls are timed on the host
clock between `torch.cuda.synchronize()` fences on the card, the
counterpart of `jax.block_until_ready`; on the card the encode's time
between two CUDA events is added as "encoding device time (ms)".
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from lrf_tpu_torch.utils.metrics import bits_per_pixel, compression_ratio, psnr, ssim
from lrf_tpu_torch.utils.transfer import resolve_device, to_host

__all__ = ["eval_compression", "read_image"]


def read_image(path: str) -> np.ndarray:
    """An image file as a `(C, H, W)` uint8 RGB array."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB")).transpose(2, 0, 1)


def eval_compression(
    image: Any,
    encoder: Callable,
    decoder: Callable,
    reconstruct: bool = False,
    device="cuda",
    **kwargs,
) -> dict:
    """Compression metrics of one image.

    `encoder(image, device=device, **kwargs)` must return the encoded
    object (bytes, or a container of tensors and bytes) and
    `decoder(encoded, device=device)` the image, as `qmf_encode` and
    `qmf_decode` do. Returns "compression ratio", "bit rate (bpp)", "PSNR
    (dB)", "SSIM", "encoding time (ms)", "decoding time (ms)" and
    "platform" ("cpu", or "cuda" with the card's name), plus, on the card,
    "encoding device time (ms)", and "reconstructed" when asked. PSNR and
    SSIM are computed on `device`.
    """
    device = resolve_device(device)
    if isinstance(image, str):
        image = read_image(image)
    image = to_host(image) if isinstance(image, torch.Tensor) else np.asarray(image)
    if image.ndim == 3 and image.shape[0] not in (1, 3) and image.shape[-1] in (1, 3):
        image = image.transpose(2, 0, 1)
    on_card = device.type == "cuda"
    fence = torch.cuda.synchronize if on_card else (lambda: None)

    fence()
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    encoded = encoder(image, device=device, **kwargs)
    if on_card:
        end.record()
    fence()
    encoding_time = 1000 * (time.perf_counter() - t0)

    t0 = time.perf_counter()
    reconstructed = decoder(encoded, device=device)
    fence()
    decoding_time = 1000 * (time.perf_counter() - t0)

    x = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    y = reconstructed.to(device) if isinstance(reconstructed, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(reconstructed)).to(device)
    output = {
        "compression ratio": float(compression_ratio(image, encoded)),
        "bit rate (bpp)": float(bits_per_pixel(image.shape[-2:], encoded)),
        "PSNR (dB)": float(psnr(x, y)),
        "SSIM": float(ssim(x, y)),
        "encoding time (ms)": encoding_time,
        "decoding time (ms)": decoding_time,
        "platform": f"cuda ({torch.cuda.get_device_name(device)})" if on_card else "cpu",
    }
    if on_card:
        output["encoding device time (ms)"] = start.elapsed_time(end)
    if reconstruct:
        output["reconstructed"] = reconstructed
    return output
