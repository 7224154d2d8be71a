"""Batched encode and decode on a device or a mesh, and several processes."""

from lrf_tpu_torch.parallel.decode import sharded_qmf_decode_batch, sharded_qmf_decode_batches
from lrf_tpu_torch.parallel.distributed import (
    allgather_bytes,
    distributed_encode,
    initialize,
    process_count,
    process_index,
    shard_range,
)
from lrf_tpu_torch.parallel.encode import build_sharded_encoder, sharded_qmf_encode_batch, sharded_qmf_encode_batches
from lrf_tpu_torch.parallel.mesh import Mesh, make_mesh
