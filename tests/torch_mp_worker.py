"""Worker process for the port's two-process distributed-encode test.

Launched by `tests/test_torch_distributed.py` as N processes forming a
`torch.distributed` gloo group on the CPU. Each process encodes its
contiguous shard of a seeded dataset with the port, the streams are
all-gathered in dataset order, and process 0 writes them, framed, to
`out_path` for the parent test to compare against one process's encodes.
Imports torch and `lrf_tpu_torch` only.

Usage: python torch_mp_worker.py <rank> <world_size> <port> <out_path>
"""

import datetime
import os
import sys


def main() -> None:
    rank, world, port, out_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch.distributed as dist

    import lrf_tpu_torch as lt
    from lrf_tpu_torch.models.container import combine_bytes

    group = dict(init_method=f"tcp://localhost:{port}", world_size=world, rank=rank, timeout=datetime.timedelta(seconds=240))
    lt.initialize(**group)
    lt.initialize(**group)  # a no-op once the group exists
    assert (lt.process_count(), lt.process_index()) == (world, rank)

    dataset = np.random.default_rng(7).integers(0, 256, (4, 3, 32, 48)).astype(np.uint8)
    streams = lt.distributed_encode(
        dataset, lambda shard: lt.sharded_qmf_encode_batch(shard, quality=20, num_iters=2, device="cpu")
    )
    assert len(streams) == len(dataset), (len(streams), len(dataset))

    # the bounded-round gather: a tiny chunk forces several rounds with
    # unequal payloads per process
    local = [bytes([65 + rank]) * (3 + 5 * rank + i) for i in range(2 + rank)]
    expected = [bytes([65 + p]) * (3 + 5 * p + i) for p in range(world) for i in range(2 + p)]
    assert lt.allgather_bytes(local, chunk_bytes=7) == expected

    if rank == 0:
        with open(out_path, "wb") as f:
            f.write(combine_bytes(list(streams) + [b"end"]))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
