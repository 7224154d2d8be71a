"""Array operations of the port: color, resampling, padding, patching,
quantization, the Gram/eigh SVD (with the opt-in Jacobi eigensolver),
HOSVD and tensor-train factorizations, the BCD solver, its CUDA kernels
and the module classes.

The names of `lrf_tpu/ops/__init__.py`, but for the kernel entry points:
the BCD kernel's wrapper `ops/bcd_kernel.py::bcd` is exported as
`bcd_cuda` and `qmf_decompose_cuda` stands for `qmf_decompose_pallas`.
`bcd` here is the solver's module (`ops/bcd.py`), and `hosvd` is the
function, as in the JAX package: import the module's other names from
`lrf_tpu_torch.ops.hosvd` directly.
"""

from lrf_tpu_torch.ops.bcd import (
    bcd_sweep,
    make_project,
    qmf_decompose,
    qmf_loss,
    qmf_reconstruct,
    svd_init,
    update_columns,
    update_w,
)
from lrf_tpu_torch.ops.bcd_kernel import bcd as bcd_cuda
from lrf_tpu_torch.ops.bcd_kernel import qmf_decompose_cuda
from lrf_tpu_torch.ops.color import rgb_to_ycbcr, ycbcr_to_rgb
from lrf_tpu_torch.ops.common import prod, relative_error, safe_divide, soft_thresholding
from lrf_tpu_torch.ops.hosvd import (
    batched_hosvd,
    batched_multi_mode_product,
    hosvd,
    hosvd_rank_feasible_ranges,
    hosvd_rank_upper_bounds,
    mode_product,
    multi_mode_product,
    unfold,
)
from lrf_tpu_torch.ops.modules import HOSVD, QMF, CoordinateDescent, RandInit, SVDInit
from lrf_tpu_torch.ops.pad import pad_amounts, pad_image, unpad_image
from lrf_tpu_torch.ops.patch import depatchify, depatchify_uv, patchify, patchify_uv
from lrf_tpu_torch.ops.quantize import dequantize, np_dequantize, quantize, to_dtype
from lrf_tpu_torch.ops.resample import (
    area_resize,
    chroma_downsample,
    chroma_downsampling,
    chroma_upsample,
    chroma_upsampling,
    nearest_resize,
    scaled_size,
)
from lrf_tpu_torch.ops.svd import svd_balanced_factors, truncated_svd
from lrf_tpu_torch.ops.tt import (
    batched_contract_tt,
    batched_ttd,
    contract_tt,
    tt_rank_feasible_ranges,
    tt_rank_upper_bounds,
    ttd,
)

__all__ = [
    "rgb_to_ycbcr", "ycbcr_to_rgb",
    "area_resize", "nearest_resize", "chroma_downsample", "chroma_downsampling", "chroma_upsample",
    "chroma_upsampling", "scaled_size",
    "pad_image", "unpad_image", "pad_amounts",
    "patchify", "depatchify", "patchify_uv", "depatchify_uv",
    "quantize", "dequantize", "to_dtype", "np_dequantize",
    "prod", "relative_error", "safe_divide", "soft_thresholding",
    "truncated_svd", "svd_balanced_factors",
    "unfold", "mode_product", "multi_mode_product", "batched_multi_mode_product", "hosvd", "batched_hosvd",
    "hosvd_rank_upper_bounds", "hosvd_rank_feasible_ranges",
    "ttd", "batched_ttd", "contract_tt", "batched_contract_tt", "tt_rank_upper_bounds", "tt_rank_feasible_ranges",
    "RandInit", "SVDInit", "CoordinateDescent", "QMF", "HOSVD",
    "bcd_cuda", "qmf_decompose_cuda",
    "qmf_decompose", "qmf_reconstruct", "qmf_loss", "svd_init", "bcd_sweep", "update_columns", "update_w",
    "make_project",
]
