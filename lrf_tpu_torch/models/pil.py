"""PIL codec wrapper: the JPEG / PNG / WebP baselines.

Port of `lrf_tpu/models/pil.py`, on the host only: `(C, H, W)` arrays to
encoded bytes through PIL and back, as the comparison experiments use the
JPEG baseline. Tensors are copied to the host first.
"""

from __future__ import annotations

import io

import numpy as np

from lrf_tpu_torch.utils.transfer import to_host

__all__ = ["pil_encode", "pil_decode"]


def pil_encode(image, **kwargs) -> bytes:
    """Encode a `(C, H, W)` (or `(H, W)`) uint8 array with PIL; kwargs go to
    `PIL.Image.save` (e.g. ``format="JPEG", quality=50``)."""
    from PIL import Image

    arr = to_host(image) if hasattr(image, "detach") else np.asarray(image)
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    buffer = io.BytesIO()
    Image.fromarray(arr).save(buffer, **kwargs)
    return buffer.getvalue()


def pil_decode(encoded_image: bytes) -> np.ndarray:
    """Decode bytes to a `(C, H, W)` (or `(H, W)`) uint8 array."""
    from PIL import Image

    arr = np.asarray(Image.open(io.BytesIO(encoded_image)))
    if arr.ndim == 3:
        arr = arr.transpose(2, 0, 1)
    return arr
