"""The AddressSanitizer pass over the port's native coder, in both flavours.

Each flavour (`full`, with libdeflate where `libdeflate.h` is found, and
`zlib-only`, `-DLRF_NO_LIBDEFLATE`, the build of the card's machine) runs
`python -m lrf_tpu_torch.native.asan_check FLAVOUR` in a child process
under `LD_PRELOAD` of g++'s ASan runtime: every entry point, error paths
included, must pass with no ASan report.
"""

import os
import subprocess
import sys

import pytest

from lrf_tpu_torch.native import asan_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("flavour", sorted(asan_check.FLAVOURS))
def test_asan_pass(flavour):
    if asan_check.asan_runtime() is None:
        pytest.skip("g++ -print-file-name=libasan.so finds no ASan runtime on this host")
    proc = subprocess.run(
        [sys.executable, "-m", "lrf_tpu_torch.native.asan_check", flavour], cwd=ROOT, env=asan_check.asan_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "AddressSanitizer" not in proc.stderr, proc.stderr[-3000:]
    assert "ALL ASAN CHECKS PASSED" in proc.stdout
    assert f"== flavour {flavour}" in proc.stdout and "-fsanitize=address" in proc.stdout


def test_asan_build_is_its_own_library():
    lib = asan_check.asan_lib("zlib-only")
    assert lib.library_path() != asan_check.m.LIB.library_path()
    assert lib.library_path() != asan_check.m.NativeLib(("-DLRF_NO_LIBDEFLATE",)).library_path()
    assert "-fsanitize=address" in lib.command("x") and "-DLRF_NO_LIBDEFLATE" in lib.command("x")
