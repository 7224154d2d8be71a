"""The port's flat namespace against the JAX package's.

`lrf_tpu`, `lrf_tpu.ops`, `lrf_tpu.models` and `lrf_tpu.utils` have no
`__all__`: their star imports also carry submodule names (`color`, `bcd`,
`modules`, `viz`, ...). So the names compared are the public ones whose
objects are not modules. Every such name of the JAX package's four
namespaces is in the port's, but two kinds:

- the kernel entry points, which the port names for CUDA: `bcd_pallas`
  and `qmf_decompose_pallas` are `bcd_cuda` and `qmf_decompose_cuda`;
- the plotting and visualization helpers of `utils/plotting.py` and
  `utils/viz.py`, which are not ported yet (ROADMAP queue 1).

A failure prints the names still missing.
"""

import types

import pytest

import lrf_tpu
import lrf_tpu_torch

RENAMED = {"bcd_pallas": "bcd_cuda", "qmf_decompose_pallas": "qmf_decompose_cuda"}
NOT_PORTED = {"LOESS", "Plot", "vis_image", "vis_image_batch", "vis_collage", "zscore_normalize", "minmax_normalize"}


def _names(mod) -> set[str]:
    return {n for n in dir(mod) if not n.startswith("_") and not isinstance(getattr(mod, n), types.ModuleType)}


@pytest.mark.parametrize("sub", ["", ".ops", ".models", ".utils"])
def test_port_exports_every_name_of_lrf_tpu(sub):
    import importlib

    jax_mod = importlib.import_module("lrf_tpu" + sub)
    port_mod = importlib.import_module("lrf_tpu_torch" + sub)
    want = _names(jax_mod) - NOT_PORTED
    have = _names(port_mod)
    missing = sorted(n for n in want if RENAMED.get(n, n) not in have)
    print(f"lrf_tpu_torch{sub}: missing {missing}")
    assert not missing, f"lrf_tpu_torch{sub} lacks {missing}"
    for old, new in RENAMED.items():
        if old in want:
            assert callable(getattr(port_mod, new)) and old not in have


def test_all_lists_resolve():
    for mod in (lrf_tpu_torch, lrf_tpu_torch.ops, lrf_tpu_torch.models, lrf_tpu_torch.utils):
        assert len(mod.__all__) == len(set(mod.__all__))
        for name in mod.__all__:
            assert not isinstance(getattr(mod, name), types.ModuleType), name
    ns: dict = {}
    exec("from lrf_tpu_torch import *", ns)
    assert _names(lrf_tpu) - NOT_PORTED - set(RENAMED) <= set(ns)


def test_shadowed_submodules_stay_importable():
    # As in the JAX package, `ops.hosvd` and `ops.quantize` are functions in
    # the namespace; their modules are importable by their dotted names, and
    # `ops.bcd`, `ops.bcd_kernel` and `ops.tt` stay modules.
    import importlib

    assert callable(lrf_tpu_torch.ops.hosvd) and callable(lrf_tpu_torch.ops.quantize)
    assert importlib.import_module("lrf_tpu_torch.ops.hosvd").hosvd is lrf_tpu_torch.ops.hosvd
    assert importlib.import_module("lrf_tpu_torch.ops.quantize").quantize is lrf_tpu_torch.ops.quantize
    for name in ("bcd", "bcd_kernel", "tt", "svd", "jacobi", "modules"):
        assert isinstance(getattr(lrf_tpu_torch.ops, name), types.ModuleType), name
    assert lrf_tpu_torch.ops.bcd_cuda is lrf_tpu_torch.ops.bcd_kernel.bcd
    # the top level's relative_error is the metric, as in lrf_tpu
    assert lrf_tpu_torch.relative_error is lrf_tpu_torch.utils.metrics.relative_error
