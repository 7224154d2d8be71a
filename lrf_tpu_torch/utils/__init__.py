"""Device selection, transfers, quality and rate metrics, the evaluation
harness and profiling."""

from lrf_tpu_torch.utils.eval import eval_compression, read_image
from lrf_tpu_torch.utils.metrics import (
    bits_per_pixel,
    compression_ratio,
    get_memory_usage,
    mae,
    mse,
    psnr,
    relative_error,
    ssim,
)
from lrf_tpu_torch.utils.profiling import annotate, device_benchmark, trace
from lrf_tpu_torch.utils.transfer import to_host, tree_to_host
