"""Guards of the port's boundaries.

- `lrf_tpu_torch` and `chip_smoke.py` import neither JAX nor `lrf_tpu`,
  and the port's native coder never loads the JAX package's library.
- Entry points run on the GPU unless asked for the CPU: with no CUDA they
  raise instead of carrying on on the CPU; so does `make_mesh()`, whose
  default is every CUDA device.
- The kernel wrapper on CPU tensors runs the plain version and launches
  nothing.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import lrf_tpu_torch
from lrf_tpu_torch.ops import bcd_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax_and_no_lrf_tpu():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import lrf_tpu_torch\n"
        "import lrf_tpu_torch.ops.bcd_kernel, lrf_tpu_torch.parallel.encode, lrf_tpu_torch.parallel.decode\n"
        "import lrf_tpu_torch.parallel.mesh, lrf_tpu_torch.parallel.distributed\n"
        "import lrf_tpu_torch.native.fibercodec, lrf_tpu_torch.ops.entropy\n"
        "import lrf_tpu_torch.utils.eval, lrf_tpu_torch.utils.profiling, lrf_tpu_torch.native.asan_check\n"
        "import lrf_tpu_torch.cli, lrf_tpu_torch.models.svd, lrf_tpu_torch.models.hosvd, lrf_tpu_torch.models.pil\n"
        "import lrf_tpu_torch.ops.jacobi, lrf_tpu_torch.ops.hosvd, lrf_tpu_torch.ops.tt, lrf_tpu_torch.ops.modules\n"
        "import lrf_tpu_torch.utils.config, lrf_tpu_torch.__main__\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and (m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'lrf_tpu'))]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "lrf_tpu_torch")):
        for f in files:
            if f.endswith((".py", ".cu", ".cpp")):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


# An import of jax, jaxlib or lrf_tpu (`\b` stops `lrf_tpu` from matching `lrf_tpu_torch`).
_FORBIDDEN_IMPORT = re.compile(
    r"^\s*(import\s+[\w., ]*\b(jax|jaxlib|lrf_tpu)\b|from\s+(jax|jaxlib|lrf_tpu)\b)"
    r"|(import_module|__import__)\(\s*[\"'](jax|jaxlib|lrf_tpu)\b",
    re.M,
)


@pytest.mark.parametrize(
    "line,bad",
    [
        ("import jax", True),
        ("import numpy as np, jax.numpy as jnp", True),
        ("    from jax import lax", True),
        ("from lrf_tpu.models.container import encode_tensor", True),
        ("import lrf_tpu", True),
        ("mod = importlib.import_module('lrf_tpu.ops.bcd')", True),
        ("import lrf_tpu_torch", False),
        ("from lrf_tpu_torch.ops import bcd", False),
        ("# Port of `lrf_tpu/ops/bcd.py`, not an import", False),
    ],
)
def test_import_scan_pattern(line, bad):
    assert bool(_FORBIDDEN_IMPORT.search(line)) == bad


def test_sources_name_no_jax_and_no_lrf_tpu_import():
    offenders = []
    for path in _sources():
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        if _FORBIDDEN_IMPORT.search(text):
            offenders.append(path)
    assert not offenders, offenders


def test_sources_name_no_jax_native_library():
    # The port builds and loads its own coder; no source of it names the JAX
    # package's library or its binding.
    for path in _sources():
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        assert "libfibercodec.so" not in text and "lrf_tpu.native" not in text, path


def test_native_coder_loads_only_the_ports_library():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from lrf_tpu_torch.models import container\n"
        "from lrf_tpu_torch.native import fibercodec\n"
        "m = np.arange(600, dtype=np.int8).reshape(100, 6)\n"
        "assert (container.decode_matrix(container.encode_matrix(m)) == m).all()\n"
        "maps = [l.split()[-1] for l in open('/proc/self/maps') if 'libfibercodec' in l]\n"
        "assert maps and all('/lrf_tpu_torch/_build/' in p for p in maps), maps\n"
        "assert str(fibercodec.LIB.library_path()) in maps\n"
        "assert not [k for k, v in sys.modules.items() if v is not None and k.split('.')[0] in ('jax', 'lrf_tpu')]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal path needs a host without it")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=tmp_path, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize(
    "entry",
    [
        "qmf_encode", "qmf_decode", "encode_batch", "decode_batch", "encode_batches", "decode_batches", "state",
        "make_mesh", "mesh_of_cuda", "svd_encode", "svd_decode", "hosvd_encode", "hosvd_decode",
        "patch_hosvd_encode", "patch_hosvd_optimal_rank",
    ],
)
def test_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal path needs a host without it")
    img = np.zeros((3, 16, 16), np.uint8)
    stream = lrf_tpu_torch.qmf_encode(img, quality=10, device="cpu")
    calls = {
        "qmf_encode": lambda: lrf_tpu_torch.qmf_encode(img, quality=10),
        "qmf_decode": lambda: lrf_tpu_torch.qmf_decode(stream),
        "encode_batch": lambda: lrf_tpu_torch.sharded_qmf_encode_batch(img[None], quality=10),
        "decode_batch": lambda: lrf_tpu_torch.sharded_qmf_decode_batch([stream]),
        "encode_batches": lambda: next(lrf_tpu_torch.sharded_qmf_encode_batches([img[None]], quality=10)),
        "decode_batches": lambda: next(lrf_tpu_torch.sharded_qmf_decode_batches([[stream]])),
        "state": lambda: lrf_tpu_torch.state_from_numpy(np.zeros((1, 4, 2)), np.zeros((1, 4, 2)), device="cuda"),
        "make_mesh": lambda: lrf_tpu_torch.make_mesh(),
        "mesh_of_cuda": lambda: lrf_tpu_torch.make_mesh(data=2, devices=["cuda:0", "cuda:1"]),
        "svd_encode": lambda: lrf_tpu_torch.svd_encode(img, quality=10),
        "svd_decode": lambda: lrf_tpu_torch.svd_decode(lrf_tpu_torch.svd_encode(img, quality=10, device="cpu")),
        "hosvd_encode": lambda: lrf_tpu_torch.hosvd_encode(img, com_ratio=10),
        "hosvd_decode": lambda: lrf_tpu_torch.hosvd_decode(lrf_tpu_torch.hosvd_encode(img, rank=(3, 4, 4), device="cpu")),
        "patch_hosvd_encode": lambda: lrf_tpu_torch.patch_hosvd_encode(img, bpp=1.0),
        "patch_hosvd_optimal_rank": lambda: lrf_tpu_torch.patch_hosvd_optimal_rank(img, 10.0),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_wrapper_on_cpu_launches_nothing():
    before = bcd_kernel.KERNEL.launches
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 64, 64)).astype(np.float32))
    u0 = torch.zeros(2, 64, 3)
    v0 = torch.ones(2, 64, 3)
    u, v = bcd_kernel.bcd(x, u0, v0, num_iters=2)
    ur, vr = bcd_kernel.bcd_reference(x, u0, v0, num_iters=2)
    assert torch.equal(u, ur) and torch.equal(v, vr)
    assert bcd_kernel.KERNEL.launches == before == 0
    assert bcd_kernel.KERNEL._lib is None  # nothing was built or loaded


def test_cuda_tests_skip_with_a_reason():
    # The kernel's own test needs a GPU; on this host it must skip, naming it.
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    import test_torch_kernel

    with pytest.raises(pytest.skip.Exception, match="CUDA device"):
        test_torch_kernel.test_kernel_matches_plain_on_gpu(1, 64, 64, 1)
