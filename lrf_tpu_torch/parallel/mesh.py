"""Device meshes for the batched codec.

Port of `lrf_tpu/parallel/mesh.py`. The codec's two scaling axes form a
`(data, patch)` grid of `torch.device`s:

- ``data``: the images of a batch, split contiguously over the rows (data
  parallelism, no communication);
- ``patch``: the rows of each image's patch-stack matrix, split over the
  devices of one data row; the BCD's sums over those rows are taken across
  the shards (`ops/bcd.py::sharded_bcd`).

A device may appear more than once (the CPU has one torch device, and one
card can stand in for several), so the cross-shard code runs anywhere.

`Mesh.map_rows` runs per-row work on one host thread per data row, so a
row whose ops wait on the host (cuSOLVER's eigh, pageable copies) does not
hold back the other rows' devices.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import torch

from lrf_tpu_torch.utils.transfer import resolve_device

__all__ = ["Mesh", "as_mesh", "make_mesh"]


class Mesh:
    """A `(data, patch)` grid of devices: `devices[i][j]` is patch shard j of
    data row i."""

    def __init__(self, devices: Sequence[Sequence]):
        rows = [tuple(resolve_device(d) for d in row) for row in devices]
        if not rows or not rows[0] or any(len(row) != len(rows[0]) for row in rows):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        self.devices = tuple(rows)

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "patch": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def first(self) -> torch.device:
        """The device of shard (0, 0), where batch results are gathered."""
        return self.devices[0][0]

    def split_batch(self, x: torch.Tensor) -> list[torch.Tensor]:
        """`x` split contiguously on dim 0, one part per data row, each on
        its row's first device (JAX's `batch_sharding`, `P("data")`)."""
        rows = len(self.devices)
        if x.shape[0] % rows:
            raise ValueError(f"a batch of {x.shape[0]} does not split evenly over {rows} data rows")
        return [part.to(row[0]) for part, row in zip(torch.chunk(x, rows), self.devices)]

    def replicate(self, x: torch.Tensor, row: Optional[int] = None) -> list[torch.Tensor]:
        """Copies of `x` on every device of the mesh, or of data row `row`,
        in grid order (JAX's `replicated`, `P()`)."""
        rows = self.devices if row is None else (self.devices[row],)
        return [x.to(d) for r in rows for d in r]

    def map_rows(self, fn: Callable, parts: Sequence) -> list:
        """`[fn(parts[i], devices[i]) for each data row i]`, in row order.

        With several rows, each row runs on its own host thread with its
        first device as the current CUDA device, so its ops go to that
        device's current stream; the calling thread joins them all and
        re-raises the first row's error. A one-row mesh runs `fn` on the
        calling thread.
        """
        if len(self.devices) == 1:
            return [fn(parts[0], self.devices[0])]
        results: list = [None] * len(self.devices)
        errors: list = [None] * len(self.devices)

        def run(i: int) -> None:
            first = self.devices[i][0]
            try:
                with torch.cuda.device(first) if first.type == "cuda" else contextlib.nullcontext():
                    results[i] = fn(parts[i], self.devices[i])
            except BaseException as e:  # handed to the calling thread below
                errors[i] = e

        threads = [threading.Thread(target=run, args=(i,), name=f"lrf_tpu_torch row {i}")
                   for i in range(len(self.devices))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        return results

    def __repr__(self) -> str:
        return f"Mesh({[[str(d) for d in row] for row in self.devices]})"


def as_mesh(device) -> Mesh:
    """A `Mesh` as it is; one device (`"cuda"`, `"cpu"`, a `torch.device`)
    as a 1 x 1 mesh. Raises when CUDA is asked for and absent."""
    return device if isinstance(device, Mesh) else Mesh([[device]])


def make_mesh(data: Optional[int] = None, patch: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A `(data, patch)` mesh over `devices` (default: every visible CUDA
    device; raises when there is none). `data * patch` must equal the
    number of devices; `data` defaults to that number over `patch`."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes every CUDA device by default, but CUDA is not available; "
                "pass devices=[...] (e.g. ['cpu'] * k) to use others"
            )
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if data is None:
        data = n // patch
    if data < 1 or patch < 1 or data * patch != n:
        raise ValueError(f"mesh {data}x{patch} does not fit {n} devices")
    return Mesh([devices[i * patch : (i + 1) * patch] for i in range(data)])
