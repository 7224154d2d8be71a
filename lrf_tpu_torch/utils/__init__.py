"""Device selection, transfers, quality and rate metrics, the evaluation
harness, results files, profiling, LOESS and rate-distortion plots, and the
visualization helpers: the names of `lrf_tpu/utils/__init__.py`."""

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
from lrf_tpu_torch.utils.plotting import LOESS, Plot
from lrf_tpu_torch.utils.profiling import annotate, device_benchmark, trace
from lrf_tpu_torch.utils.transfer import state_from_numpy, to_host, tree_to_host
from lrf_tpu_torch.utils.viz import minmax_normalize, vis_collage, vis_image, vis_image_batch, zscore_normalize

__all__ = [
    "mae", "mse", "relative_error", "psnr", "ssim", "get_memory_usage", "compression_ratio", "bits_per_pixel",
    "eval_compression", "read_image",
    "read_config", "save_config", "json_serializer",
    "to_host", "tree_to_host", "state_from_numpy",
    "trace", "annotate", "device_benchmark",
    "LOESS", "Plot",
    "vis_image", "vis_image_batch", "vis_collage", "zscore_normalize", "minmax_normalize",
]
