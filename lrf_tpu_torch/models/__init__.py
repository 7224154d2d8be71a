"""Codecs of the port: QMF, SVD, HOSVD and patch-HOSVD, the PIL baselines,
and the byte container. The names of `lrf_tpu/models/__init__.py`."""

from lrf_tpu_torch.models.container import (
    bytes_to_dict,
    combine_bytes,
    decode_matrix,
    decode_tensor,
    dict_to_bytes,
    encode_matrix,
    encode_tensor,
    get_fiber_coder,
    separate_bytes,
    set_fiber_coder,
)
from lrf_tpu_torch.models.hosvd import (
    hosvd_compression_ratio,
    hosvd_decode,
    hosvd_encode,
    hosvd_rank,
    patch_hosvd_decode,
    patch_hosvd_detensorize,
    patch_hosvd_encode,
    patch_hosvd_optimal_rank,
    patch_hosvd_tensorize,
)
from lrf_tpu_torch.models.pil import pil_decode, pil_encode
from lrf_tpu_torch.models.qmf import qmf_decode, qmf_encode, qmf_rank
from lrf_tpu_torch.models.svd import svd_compression_ratio, svd_decode, svd_encode, svd_rank

__all__ = [
    "combine_bytes", "separate_bytes", "dict_to_bytes", "bytes_to_dict", "encode_matrix", "decode_matrix",
    "encode_tensor", "decode_tensor", "set_fiber_coder", "get_fiber_coder",
    "qmf_encode", "qmf_decode", "qmf_rank",
    "svd_encode", "svd_decode", "svd_rank", "svd_compression_ratio",
    "hosvd_encode", "hosvd_decode", "hosvd_rank", "hosvd_compression_ratio", "patch_hosvd_encode",
    "patch_hosvd_decode", "patch_hosvd_optimal_rank", "patch_hosvd_tensorize", "patch_hosvd_detensorize",
    "pil_encode", "pil_decode",
]
