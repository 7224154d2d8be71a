"""JSON results and config files, with dtype (de)serialization hooks.

Port of `lrf_tpu/utils/config.py`: `save_config(results, save_dir=...,
prefix=...)` writes ``{prefix}_results.json`` with the same JSON text as
the JAX package, and `read_config` revives dtype strings. Dtypes are
written as ``"dtype::<name>"`` (numpy or torch dtypes alike); the
reference's ``"torch.<name>"`` strings are read back as numpy dtypes too.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

__all__ = ["json_serializer", "json_deserializer", "save_config", "read_config"]

_DTYPE_PREFIX = "dtype::"


def json_serializer(obj: Any):
    """`json.dump` hook for numpy and torch dtypes, arrays, tensors and
    numpy scalars."""
    if isinstance(obj, torch.dtype):
        obj = np.dtype(str(obj).split(".", 1)[1])
    if isinstance(obj, np.dtype):
        return _DTYPE_PREFIX + obj.name
    if isinstance(obj, type) and issubclass(obj, np.generic):
        return _DTYPE_PREFIX + np.dtype(obj).name
    if hasattr(obj, "dtype") and hasattr(obj, "tolist"):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    raise TypeError(f"Object of type {type(obj)} is not JSON serializable")


def json_deserializer(dct: dict) -> dict:
    """`json.load` object hook reviving dtype strings, the reference's
    ``torch.<name>`` among them, as numpy dtypes."""
    for key, value in dct.items():
        if isinstance(value, str):
            if value.startswith(_DTYPE_PREFIX):
                dct[key] = np.dtype(value[len(_DTYPE_PREFIX):])
            elif value.startswith("torch."):
                try:
                    dct[key] = np.dtype(value.split(".", 1)[1])
                except TypeError:
                    pass
    return dct


def save_config(data: Sequence[dict] | dict, save_dir: Optional[str] = None, prefix: str = "") -> None:
    """Write `data` to ``{save_dir}/{prefix}_results.json``.

    The write is atomic (a temporary file, then a rename), so a crash in
    the middle never leaves a half-written file where a sweep resumes from.
    """
    if save_dir is None:
        raise FileNotFoundError("Save directory must be specified")
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{prefix}_results.json")
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=4, default=json_serializer)
    os.replace(tmp, path)


def read_config(file_name: str):
    """Load a results or config JSON file, reviving dtype strings."""
    with open(file_name) as f:
        return json.load(f, object_hook=json_deserializer)
