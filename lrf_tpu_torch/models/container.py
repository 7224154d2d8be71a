"""Bitstream container: length-prefixed framing + per-fiber zlib coding.

Port of `lrf_tpu/models/container.py:49-293` on its pure-Python zlib path
(`:147-158`); the bytes are the format of the JAX package and of the
reference codec:

- `combine_bytes` left-folds payloads as ``len(p1) (4-byte big-endian) ||
  p1 || p2``; `separate_bytes` peels them in reverse;
- metadata is a UTF-8 JSON dict;
- 2-D tensors are split into columns ("fibers"), each zlib-9 compressed on
  its own, with inner metadata ``{"num_fibers", "mode", "dtype"}``; N-D
  tensors are one whole-buffer zlib-9 blob with ``{"shape", "dtype"}``.

The native fiber coder (libdeflate) is not ported yet, so the "best" and
"deflate" backends give zlib-9 bytes, as the JAX package does when its
native library is absent.
"""

from __future__ import annotations

import functools
import json
import zlib
from typing import Optional, Sequence

import numpy as np

_DEFAULT_LEVELS = {"zlib": 9, "deflate": 6, "best": 0}
_FIBER_CODER: dict = {"backend": "best", "level": 0}


def set_fiber_coder(backend: str = "zlib", level: Optional[int] = None) -> None:
    """Set the process-wide default fiber compressor."""
    if backend not in _DEFAULT_LEVELS:
        raise ValueError(f"unknown coder backend {backend!r}")
    _FIBER_CODER["backend"] = backend
    _FIBER_CODER["level"] = _DEFAULT_LEVELS[backend] if level is None else level


def get_fiber_coder() -> tuple[str, int]:
    return _FIBER_CODER["backend"], _FIBER_CODER["level"]


def _zlib_level(coder) -> int:
    """zlib level for a coder spec: the zlib backend's own level, else 9."""
    if coder is None:
        backend, level = get_fiber_coder()
    elif isinstance(coder, str):
        backend, level = coder, _DEFAULT_LEVELS[coder]
    else:
        backend, level = coder
        level = _DEFAULT_LEVELS[backend] if level is None else level
    if backend not in _DEFAULT_LEVELS:
        raise ValueError(f"unknown coder backend {backend!r}")
    return level if backend == "zlib" else 9


def _combine_two(payload1: bytes, payload2: bytes) -> bytes:
    if len(payload1) > 0xFFFFFFFF:
        raise ValueError("payload1 is too large to encode.")
    return len(payload1).to_bytes(4, byteorder="big") + payload1 + payload2


def _separate_two(combined: bytes) -> tuple[bytes, bytes]:
    if len(combined) < 4:
        raise ValueError("Combined data is too short to decode.")
    n = int.from_bytes(combined[:4], byteorder="big")
    return combined[4 : 4 + n], combined[4 + n :]


def combine_bytes(payloads: Sequence[bytes]) -> bytes:
    """Left-fold payloads into one framed stream."""
    return functools.reduce(_combine_two, payloads)


def separate_bytes(combined: bytes, num_payloads: int = 2) -> tuple[bytes, ...]:
    """Split a framed stream back into `num_payloads` payloads."""
    payloads: list[bytes] = []
    head = combined
    for _ in range(num_payloads - 1):
        head, tail = _separate_two(head)
        payloads.insert(0, tail)
    payloads.insert(0, head)
    return tuple(payloads)


def dict_to_bytes(d: dict) -> bytes:
    return json.dumps(d).encode("utf-8")


def bytes_to_dict(b: bytes) -> dict:
    return json.loads(b.decode("utf-8"))


def encode_matrix(matrix: np.ndarray, mode: str = "col", coder=None) -> bytes:
    """Per-fiber zlib coding of a 2-D array."""
    if matrix.ndim != 2:
        raise ValueError("'matrix' must be 2-D.")
    if mode not in ("col", "row"):
        raise ValueError("'mode' must be 'col' or 'row'.")
    matrix = np.ascontiguousarray(matrix)
    level = _zlib_level(coder)
    if mode == "col":
        fibers = [matrix[:, i : i + 1] for i in range(matrix.shape[1])]
    else:
        fibers = [matrix[i : i + 1, :] for i in range(matrix.shape[0])]
    encoded = [zlib.compress(np.ascontiguousarray(f).tobytes(), level) for f in fibers]
    metadata = {"num_fibers": len(fibers), "mode": mode, "dtype": matrix.dtype.name}
    return combine_bytes([dict_to_bytes(metadata), combine_bytes(encoded)])


def decode_matrix(encoded_matrix: bytes) -> np.ndarray:
    """Inverse of `encode_matrix`."""
    encoded_metadata, encoded_fibers = separate_bytes(encoded_matrix)
    metadata = bytes_to_dict(encoded_metadata)
    dtype = np.dtype(metadata["dtype"])
    blobs = separate_bytes(encoded_fibers, num_payloads=metadata["num_fibers"])
    fibers = [np.frombuffer(zlib.decompress(blob), dtype=dtype) for blob in blobs]
    return np.stack(fibers, axis=1 if metadata["mode"] == "col" else 0)


def decode_matrix_batch(encoded_matrices: Sequence[bytes]) -> np.ndarray:
    """Batched inverse of `encode_matrix` over same-shape streams: `(B, M, N)`."""
    decoded = [decode_matrix(b) for b in encoded_matrices]
    if any(d.shape != decoded[0].shape or d.dtype != decoded[0].dtype for d in decoded):
        raise ValueError("decode_matrix_batch requires homogeneous streams")
    return np.stack(decoded)


def encode_matrix_batch(tensors: np.ndarray, mode: str = "col", coder=None) -> list[bytes]:
    """Per-image `encode_matrix` over a `(B, M, N)` stack."""
    if tensors.ndim != 3:
        raise ValueError("encode_matrix_batch takes a (B, M, N) stack")
    return [encode_matrix(t, mode, coder) for t in tensors]


def encode_tensor(tensor: np.ndarray, coder=None) -> bytes:
    """2-D -> `encode_matrix`; N-D -> whole-buffer zlib."""
    tensor = np.asarray(tensor)
    if tensor.ndim == 2:
        return encode_matrix(tensor, coder=coder)
    payload = zlib.compress(np.ascontiguousarray(tensor).tobytes(), _zlib_level(coder))
    metadata = {"shape": list(tensor.shape), "dtype": tensor.dtype.name}
    return combine_bytes([dict_to_bytes(metadata), payload])


def encode_tensor_batch(tensors: np.ndarray, coder=None) -> list[bytes]:
    """Per-image `encode_tensor` over a stack; bytes equal the unbatched calls."""
    tensors = np.asarray(tensors)
    if tensors.ndim == 3:
        return encode_matrix_batch(tensors, coder=coder)
    return [encode_tensor(t, coder=coder) for t in tensors]


def decode_tensor(encoded_tensor: bytes) -> np.ndarray:
    """Inverse of `encode_tensor`."""
    encoded_metadata, payload = separate_bytes(encoded_tensor)
    metadata = bytes_to_dict(encoded_metadata)
    if "num_fibers" in metadata:
        return decode_matrix(encoded_tensor)
    dtype = np.dtype(metadata["dtype"])
    return np.frombuffer(zlib.decompress(payload), dtype=dtype).reshape(metadata["shape"])
