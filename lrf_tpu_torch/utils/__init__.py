"""Device selection, transfers, quality and rate metrics, the evaluation
harness, results files and profiling. The names of
`lrf_tpu/utils/__init__.py` but the plotting and visualization helpers."""

from lrf_tpu_torch.utils.config import json_serializer, read_config, save_config
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
from lrf_tpu_torch.utils.transfer import state_from_numpy, to_host, tree_to_host

__all__ = [
    "mae", "mse", "relative_error", "psnr", "ssim", "get_memory_usage", "compression_ratio", "bits_per_pixel",
    "eval_compression", "read_image",
    "read_config", "save_config", "json_serializer",
    "to_host", "tree_to_host", "state_from_numpy",
    "trace", "annotate", "device_benchmark",
]
