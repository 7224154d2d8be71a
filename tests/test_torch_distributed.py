"""The port's process layer (`parallel/distributed.py`) against the JAX package's.

- `shard_range` equals `lrf_tpu.parallel.distributed.shard_range` for
  n in 0..20 and count in 1..5, and the slices tile the dataset in order.
- Without a process group: one process, index 0, `allgather_bytes` the
  identity, `distributed_encode` the encode of the whole dataset.
- A real two-process gloo group on the CPU (`tests/torch_mp_worker.py`):
  the ordered streams equal one process's port encodes, at least n - 1
  byte for byte and the rest within 0.2 dB.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import lrf_tpu_torch as lt
from lrf_tpu_torch.models.container import separate_bytes
from lrf_tpu_torch.parallel import distributed as td


def test_shard_range_matches_jax():
    from lrf_tpu.parallel.distributed import shard_range as jax_shard_range

    for n in range(21):
        for count in range(1, 6):
            spans = [td.shard_range(n, i, count) for i in range(count)]
            assert spans == [jax_shard_range(n, i, count) for i in range(count)]
            assert [k for s, e in spans for k in range(s, e)] == list(range(n))


def test_single_process_is_the_identity():
    assert (td.process_count(), td.process_index()) == (1, 0)
    assert td.shard_range(10) == (0, 10)
    blobs = [b"a", b"bc" * 10, b""]
    assert td.allgather_bytes(blobs) == blobs
    assert td.allgather_bytes([]) == []
    images = np.random.default_rng(3).integers(0, 256, (3, 3, 32, 48)).astype(np.uint8)

    def encode(shard):
        return lt.sharded_qmf_encode_batch(shard, quality=10, num_iters=1, device="cpu")

    assert td.distributed_encode(images, encode) == encode(images)


def test_two_process_distributed_encode(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_path = tmp_path / "streams.bin"
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mp_worker.py")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(rank), "2", str(port), str(out_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for rank in range(2)
    ]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    *streams, tail = separate_bytes(out_path.read_bytes(), 5)
    assert tail == b"end"
    dataset = np.random.default_rng(7).integers(0, 256, (4, 3, 32, 48)).astype(np.uint8)
    n_identical = 0
    for img, stream in zip(dataset, streams):
        expected = lt.sharded_qmf_encode_batch(img[None], quality=20, num_iters=2, device="cpu")[0]
        if stream == expected:
            n_identical += 1
        else:
            p_one = float(lt.psnr(img, lt.qmf_decode(expected, device="cpu")))
            p_two = float(lt.psnr(img, lt.qmf_decode(stream, device="cpu")))
            assert abs(p_one - p_two) < 0.2, (p_one, p_two)
    assert n_identical >= len(dataset) - 1, f"only {n_identical} byte-identical"


def test_initialize_takes_gloo_by_default(monkeypatch):
    seen = {}
    monkeypatch.setattr(td.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(td.dist, "init_process_group", lambda **kw: seen.update(kw))
    td.initialize(init_method="tcp://localhost:1", world_size=2, rank=0)
    assert seen == {"backend": "gloo", "init_method": "tcp://localhost:1", "world_size": 2, "rank": 0}
    seen.clear()
    td.initialize(backend="nccl")
    assert seen == {"backend": "nccl"}
    monkeypatch.setattr(td.dist, "is_initialized", lambda: True)
    seen.clear()
    td.initialize(backend="gloo")
    assert seen == {}


@pytest.mark.parametrize("chunk_bytes", [1, 7, 1 << 20])
def test_allgather_rounds_reassemble(monkeypatch, chunk_bytes):
    # Three simulated processes: each all-gather returns every process's
    # array; the rounds and the length tables must rebuild the blobs in
    # process order.
    local = {p: [bytes([65 + p]) * (3 + 5 * p + i) for i in range(2 + p)] for p in range(3)}
    calls = []

    def fake_allgather(array):
        k = len(calls)
        calls.append(array.copy())
        if k == 0:
            return np.stack([np.asarray([len(local[p])], np.int64) for p in range(3)])
        if k == 1:
            lens = np.zeros((3, array.shape[0]), np.int64)
            for p in range(3):
                lens[p, : len(local[p])] = [len(b) for b in local[p]]
            return lens
        lo = (k - 2) * chunk_bytes
        out = np.zeros((3, chunk_bytes), np.uint8)
        for p in range(3):
            flat = np.frombuffer(b"".join(local[p]), np.uint8)[lo : lo + chunk_bytes]
            out[p, : len(flat)] = flat
        return out

    monkeypatch.setattr(td, "process_count", lambda: 3)
    monkeypatch.setattr(td, "_allgather", fake_allgather)
    got = td.allgather_bytes(local[0], chunk_bytes=chunk_bytes)
    assert got == [b for p in range(3) for b in local[p]]
    longest = max(sum(len(b) for b in local[p]) for p in range(3))
    assert len(calls) == 2 + -(-longest // chunk_bytes)
