"""Array operations of the port: color, resampling, padding, patching,
clamp-casts, the Gram/eigh SVD, the BCD solver and its CUDA kernel.

Exported here: the names of `lrf_tpu/ops/__init__.py` that are ported so
far. The kernel's wrapper is `lrf_tpu_torch.ops.bcd_kernel.bcd` (the name
`bcd` here is the solver's module, `ops/bcd.py`)."""

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
from lrf_tpu_torch.ops.color import rgb_to_ycbcr, ycbcr_to_rgb
from lrf_tpu_torch.ops.common import prod, relative_error, safe_divide, soft_thresholding
from lrf_tpu_torch.ops.pad import pad_amounts, pad_image, unpad_image
from lrf_tpu_torch.ops.patch import depatchify, depatchify_uv, patchify, patchify_uv
from lrf_tpu_torch.ops.quantize import to_dtype
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
