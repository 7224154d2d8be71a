"""lrf_tpu_torch: the QMF image codec on PyTorch and CUDA.

A port of `lrf_tpu` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA Hopper
GPU. The fused BCD loop is hand-written CUDA (`lrf_tpu_torch/csrc/`), built
with `nvcc` at first use; the host serializer is the native fiber coder
(`lrf_tpu_torch/native/fibercodec.cpp`), built with g++ at first use;
everything else is PyTorch. Entry points take `device=` and run on `"cuda"` unless
the caller asks for `"cpu"`; the batched ones also take a device mesh
(`make_mesh`), and `distributed_encode` spreads a dataset over processes.
Streams are byte-format compatible with `lrf_tpu` and decode in either
package.

This package imports neither JAX nor `lrf_tpu`.
"""

from lrf_tpu_torch.models.container import get_fiber_coder, set_fiber_coder
from lrf_tpu_torch.models.qmf import qmf_decode, qmf_encode, qmf_rank
from lrf_tpu_torch.parallel.decode import sharded_qmf_decode_batch, sharded_qmf_decode_batches
from lrf_tpu_torch.parallel.distributed import (
    allgather_bytes,
    distributed_encode,
    initialize,
    process_count,
    process_index,
    shard_range,
)
from lrf_tpu_torch.parallel.encode import (
    EntropyOverflowError,
    build_sharded_encoder,
    sharded_qmf_encode_batch,
    sharded_qmf_encode_batches,
)
from lrf_tpu_torch.parallel.mesh import Mesh, make_mesh
from lrf_tpu_torch.utils.metrics import mse, psnr
from lrf_tpu_torch.utils.transfer import state_from_numpy, to_host

__all__ = [
    "qmf_encode",
    "qmf_decode",
    "qmf_rank",
    "sharded_qmf_encode_batch",
    "sharded_qmf_encode_batches",
    "sharded_qmf_decode_batch",
    "sharded_qmf_decode_batches",
    "build_sharded_encoder",
    "EntropyOverflowError",
    "Mesh",
    "make_mesh",
    "initialize",
    "process_count",
    "process_index",
    "shard_range",
    "allgather_bytes",
    "distributed_encode",
    "set_fiber_coder",
    "get_fiber_coder",
    "mse",
    "psnr",
    "state_from_numpy",
    "to_host",
]

__version__ = "0.1.0"
