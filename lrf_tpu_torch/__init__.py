"""lrf_tpu_torch: the QMF image codec on PyTorch and CUDA.

A port of `lrf_tpu` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA Hopper
GPU. The fused BCD loop is hand-written CUDA (`lrf_tpu_torch/csrc/`), built
with `nvcc` at first use; the host serializer is the native fiber coder
(`lrf_tpu_torch/native/fibercodec.cpp`), built with g++ at first use;
everything else is PyTorch. Entry points take `device=` and run on `"cuda"` unless
the caller asks for `"cpu"`; the batched ones also take a device mesh
(`make_mesh`), and `distributed_encode` spreads a dataset over processes.
Streams are byte-format compatible with `lrf_tpu` and decode in either
package. The namespace is flat, as `lrf_tpu`'s is: every op, codec and
util of `lrf_tpu_torch.ops`, `.models` and `.utils`, and the batched,
mesh and multi-process entry points of `.parallel`. The command line is
`python -m lrf_tpu_torch` (`lrf_tpu_torch/cli.py`); the rate-distortion
sweeps and ablations are `lrf_tpu_torch.experiments` (`python -m
lrf_tpu_torch.experiments`), and the codec's single encode step and a
sharded dry run are `lrf_tpu_torch.entry`.

This package imports neither JAX nor `lrf_tpu`.
"""

from lrf_tpu_torch import models, ops, utils
from lrf_tpu_torch.ops import *  # noqa: F401,F403
from lrf_tpu_torch.models import *  # noqa: F401,F403
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
from lrf_tpu_torch.utils import *  # noqa: F401,F403

# `relative_error` is the metric of `utils` (over the last three dims), as
# in `lrf_tpu`, whose star import of `utils` comes last.
__all__ = list(dict.fromkeys([
    *ops.__all__,
    *models.__all__,
    *utils.__all__,
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
]))

__version__ = "0.1.0"
