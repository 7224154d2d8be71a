"""Several processes: init, dataset sharding, ordered stream gather.

Port of `lrf_tpu/parallel/distributed.py` onto `torch.distributed`:

- each process calls `initialize()` (`init_process_group`, gloo by
  default, since what is gathered is host bytes), then encodes its
  contiguous slice of the dataset on its own devices;
- encoded streams are bytes of varying length, so the gather has two
  phases: an all-gather of each process's blob count and length table,
  then the payloads, each process's blobs flattened into one buffer,
  all-gathered in rounds of a fixed `chunk_bytes` (peak gather memory
  `P x chunk_bytes` a round, whatever the dataset's size), reassembled in
  dataset order on every process.

Without a process group `process_count()` is 1 and every gather is the
identity.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "process_count",
    "process_index",
    "shard_range",
    "allgather_bytes",
    "distributed_encode",
]


def _group_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(**kwargs) -> None:
    """`torch.distributed.init_process_group(**kwargs)`, with
    `backend="gloo"` unless given; a no-op when a group already exists.
    Nothing here discovers a cluster: pass `init_method` (e.g.
    `"tcp://host:port"`), `world_size` and `rank`, or set the `env://`
    variables."""
    if _group_ready():
        return
    kwargs.setdefault("backend", "gloo")
    dist.init_process_group(**kwargs)


def process_count() -> int:
    return dist.get_world_size() if _group_ready() else 1


def process_index() -> int:
    return dist.get_rank() if _group_ready() else 0


def shard_range(n_items: int, index: Optional[int] = None, count: Optional[int] = None):
    """Contiguous `[start, end)` slice of a dataset for this process: the
    first `n % count` processes take one item more, so concatenating the
    slices in process order gives the dataset's order."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    base, extra = divmod(n_items, count)
    start = index * base + min(index, extra)
    return start, start + base + (1 if index < extra else 0)


def _allgather(array: np.ndarray) -> np.ndarray:
    """All-gather of a same-shape host array: `(P, *shape)`."""
    local = torch.from_numpy(np.ascontiguousarray(array))
    parts = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(parts, local)
    return torch.stack(parts).numpy()


def allgather_bytes(local_blobs: Sequence[bytes], chunk_bytes: int = 8 * 1024 * 1024) -> list[bytes]:
    """All-gather byte blobs of any length across processes, in process
    order, in bounded rounds.

    (1) a gather of each process's blob count, then of its length table
    padded to the largest count; (2) each process's blobs as one flat
    payload, gathered `chunk_bytes` at a time for ceil(longest payload /
    chunk_bytes) rounds, a process whose payload has ended sending zeros.
    The identity with one process.
    """
    if process_count() == 1:
        return list(local_blobs)
    p_count = process_count()
    counts = _allgather(np.asarray([len(local_blobs)], np.int64)).reshape(-1)
    lens = np.zeros(int(counts.max()), dtype=np.int64)
    lens[: len(local_blobs)] = [len(b) for b in local_blobs]
    all_lens = _allgather(lens)
    totals = all_lens.sum(axis=1)
    max_total = int(totals.max())
    flat = np.frombuffer(b"".join(local_blobs), dtype=np.uint8)
    payloads = [bytearray() for _ in range(p_count)]
    for lo in range(0, max_total, chunk_bytes):
        piece = np.zeros(chunk_bytes, dtype=np.uint8)
        part = flat[lo : lo + chunk_bytes]
        piece[: len(part)] = part
        gathered = _allgather(piece)
        for p in range(p_count):
            need = int(totals[p]) - lo
            if need > 0:
                payloads[p] += gathered[p, : min(need, chunk_bytes)].tobytes()
    out: list[bytes] = []
    for p in range(p_count):
        off = 0
        for n in all_lens[p, : int(counts[p])].tolist():
            out.append(bytes(payloads[p][off : off + n]))
            off += n
    return out


def distributed_encode(images: np.ndarray, encode_batch: Callable[[np.ndarray], list[bytes]]) -> list[bytes]:
    """Data-parallel dataset encode with an ordered gather.

    `images`: the whole `(N, 3, H, W)` dataset (every process sees the same
    array, or a memory-mapped equivalent). Each process encodes its
    contiguous shard with `encode_batch`, then the streams are all-gathered
    in dataset order. Returns the whole ordered list on every process.
    """
    start, end = shard_range(len(images))
    local = encode_batch(images[start:end]) if end > start else []
    return allgather_bytes(local)
