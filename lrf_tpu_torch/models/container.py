"""Bitstream container: length-prefixed framing + per-fiber DEFLATE coding.

Port of `lrf_tpu/models/container.py`; the bytes are the format of the JAX
package and of the reference codec:

- `combine_bytes` left-folds payloads as ``len(p1) (4-byte big-endian) ||
  p1 || p2``; `separate_bytes` peels them in reverse;
- metadata is a UTF-8 JSON dict;
- 2-D tensors are split into columns ("fibers"), each DEFLATE-compressed on
  its own, with inner metadata ``{"num_fibers", "mode", "dtype"}``; N-D
  tensors are one whole-buffer blob with ``{"shape", "dtype"}``.

Fibers go through the port's native coder (`lrf_tpu_torch/native`,
thread-pooled C++), with one of three backends (`set_fiber_coder`):

- ``"best"`` (default): per fiber the smaller of zlib-9 and libdeflate
  level 12, ties to zlib; plain zlib-9 where the native coder was built
  without libdeflate, as the JAX package does without its library;
- ``"zlib"``: bytes identical to the reference's `zlib.compress(fiber, 9)`;
- ``"deflate"``: libdeflate at level 6; raises where the native coder was
  built without libdeflate.

Every blob is a standard zlib stream, so the reference decoder reads them
all. `encode_matrix_plain` is the plain pure-Python zlib version of
`encode_matrix(..., coder="zlib")`, which the tests and `chip_smoke.py`
hold the native coder against.
"""

from __future__ import annotations

import functools
import json
import zlib
from typing import Optional, Sequence

import numpy as np

from lrf_tpu_torch.native import fibercodec as _native

_DEFAULT_LEVELS = {"zlib": 9, "deflate": 6, "best": 0}
# "best" ignores its level: it always races zlib-9 against libdeflate-12.
_FIBER_CODER: dict = {"backend": "best", "level": 0}


def set_fiber_coder(backend: str = "zlib", level: Optional[int] = None) -> None:
    """Set the process-wide default fiber compressor."""
    if backend not in _DEFAULT_LEVELS:
        raise ValueError(f"unknown coder backend {backend!r}")
    _FIBER_CODER["backend"] = backend
    _FIBER_CODER["level"] = _DEFAULT_LEVELS[backend] if level is None else level


def get_fiber_coder() -> tuple[str, int]:
    return _FIBER_CODER["backend"], _FIBER_CODER["level"]


def _resolve_coder(coder) -> tuple[str, int]:
    """None -> process default; str -> backend at its default level."""
    if coder is None:
        return get_fiber_coder()
    backend, level = (coder, None) if isinstance(coder, str) else coder
    if backend not in _DEFAULT_LEVELS:
        raise ValueError(f"unknown coder backend {backend!r}")
    return backend, _DEFAULT_LEVELS[backend] if level is None else level


def _compress_fibers(matrix: np.ndarray, mode: str, level: int, backend: str) -> list[bytes]:
    """Native fiber compression, with the "best" race: every fiber through
    zlib-9 and libdeflate-12, the smaller blob wins, ties to zlib."""
    if backend != "best":
        return _native.compress_fibers(matrix, mode, level, backend)
    blobs_z = _native.compress_fibers(matrix, mode, 9, "zlib")
    if "deflate" not in _native.backends():
        return blobs_z
    blobs_d = _native.compress_fibers(matrix, mode, 12, "deflate")
    return [z if len(z) <= len(d) else d for z, d in zip(blobs_z, blobs_d)]


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


def _check_matrix(matrix: np.ndarray, mode: str) -> None:
    if matrix.ndim != 2:
        raise ValueError("'matrix' must be 2-D.")
    if mode not in ("col", "row"):
        raise ValueError("'mode' must be 'col' or 'row'.")


def _frame_matrix(blobs: Sequence[bytes], mode: str, dtype: np.dtype) -> bytes:
    metadata = {"num_fibers": len(blobs), "mode": mode, "dtype": np.dtype(dtype).name}
    return combine_bytes([dict_to_bytes(metadata), combine_bytes(blobs)])


def encode_matrix(matrix: np.ndarray, mode: str = "col", coder=None) -> bytes:
    """Per-fiber DEFLATE coding of a 2-D array, through the native coder."""
    _check_matrix(matrix, mode)
    matrix = np.ascontiguousarray(matrix)
    backend, level = _resolve_coder(coder)
    return _frame_matrix(_compress_fibers(matrix, mode, level, backend), mode, matrix.dtype)


def encode_matrix_plain(matrix: np.ndarray, mode: str = "col", level: int = 9) -> bytes:
    """Plain version of `encode_matrix(..., coder=("zlib", level))`: one
    CPython `zlib.compress` per fiber."""
    _check_matrix(matrix, mode)
    fibers = matrix.T if mode == "col" else matrix
    blobs = [zlib.compress(np.ascontiguousarray(f).tobytes(), level) for f in fibers]
    return _frame_matrix(blobs, mode, matrix.dtype)


def _matrix_fibers(encoded_matrix: bytes) -> tuple[dict, tuple[bytes, ...]]:
    encoded_metadata, encoded_fibers = separate_bytes(encoded_matrix)
    metadata = bytes_to_dict(encoded_metadata)
    return metadata, separate_bytes(encoded_fibers, num_payloads=metadata["num_fibers"])


def decode_matrix(encoded_matrix: bytes) -> np.ndarray:
    """Inverse of `encode_matrix`."""
    metadata, blobs = _matrix_fibers(encoded_matrix)
    return _native.decompress_fibers(blobs, np.dtype(metadata["dtype"]), metadata["mode"])


def decode_matrix_batch(encoded_matrices: Sequence[bytes]) -> np.ndarray:
    """Batched inverse of `encode_matrix` over same-shape streams: `(B, M, N)`.

    All B streams' fibers inflate in one native call.
    """
    metadata = None
    blobs: list[bytes] = []
    for blob in encoded_matrices:
        md, fibers = _matrix_fibers(blob)
        if metadata is None:
            metadata = md
        elif md != metadata:
            raise ValueError("decode_matrix_batch requires homogeneous streams")
        blobs.extend(fibers)
    if metadata is None:
        raise ValueError("no streams to decode")
    fibers = _native.decompress_fibers_raw(blobs, np.dtype(metadata["dtype"]))
    fibers = fibers.reshape(len(encoded_matrices), metadata["num_fibers"], -1)
    return fibers.transpose(0, 2, 1) if metadata["mode"] == "col" else fibers


def encode_matrix_batch(tensors: np.ndarray, mode: str = "col", coder=None) -> list[bytes]:
    """Per-image `encode_matrix` over a `(B, M, N)` stack; all B * N fibers
    deflate in one native call. Bytes equal the per-image calls."""
    if tensors.ndim != 3:
        raise ValueError("encode_matrix_batch takes a (B, M, N) stack")
    if mode not in ("col", "row"):
        raise ValueError("'mode' must be 'col' or 'row'.")
    b, m, n = tensors.shape
    per = n if mode == "col" else m
    backend, level = _resolve_coder(coder)
    block = np.ascontiguousarray(tensors.transpose(0, 2, 1) if mode == "col" else tensors).reshape(b * per, -1)
    blobs = _compress_fibers(block, "row", level, backend)
    return [_frame_matrix(blobs[i * per : (i + 1) * per], mode, tensors.dtype) for i in range(b)]


def encode_tensor(tensor: np.ndarray, coder=None) -> bytes:
    """2-D -> `encode_matrix`; N-D -> one whole-buffer blob."""
    tensor = np.asarray(tensor)
    if tensor.ndim == 2:
        return encode_matrix(tensor, coder=coder)
    backend, level = _resolve_coder(coder)
    raw = np.ascontiguousarray(tensor).reshape(1, -1).view(np.uint8)
    payload = _compress_fibers(raw, "row", level, backend)[0]
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
