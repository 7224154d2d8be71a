"""The port's command line (`python -m lrf_tpu_torch`) and results files
against the JAX package's.

- `encode` / `decode` / `info` / `eval` with `--device cpu`; `decode` and
  `info` tell an SVD stream from its metadata.
- A stream the port's CLI writes decodes under `lrf_tpu.cli.main` (the code
  of `python -m lrf_tpu decode`) to the pixels the port's CLI decodes, and
  the other way round, within the QMF cross-decode contract (at most 1
  apart, in under 0.1% of pixels); the port's QMF stream equals
  `qmf_encode`'s with the same arguments.
- `--device cuda` without CUDA exits non-zero with a message naming CUDA.
- `save_config` writes the JAX package's JSON text and `read_config`
  revives the dtypes.

The JAX package is imported inside the tests that use it, so the `cuda`
test runs on a GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cli.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import lrf_tpu_torch as lt
from lrf_tpu_torch.cli import main

import torch_images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "img.png"
    img = torch_images.photos(1, 64, 96, seed=12)[0]
    Image.fromarray(img.transpose(1, 2, 0)).save(path)
    return path


def _read(path):
    return np.asarray(Image.open(path).convert("RGB")).transpose(2, 0, 1)


def _close_pixels(a, b):
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_encode_decode_info_eval(png, tmp_path, capsys):
    stream_path, out_path = tmp_path / "img.lrf", tmp_path / "round.png"
    assert main(["--device", "cpu", "encode", str(png), str(stream_path), "--quality", "10"]) == 0
    assert stream_path.read_bytes() == lt.qmf_encode(_read(png), quality=10, device="cpu")
    assert main(["--device", "cpu", "decode", str(stream_path), str(out_path)]) == 0
    np.testing.assert_array_equal(_read(out_path), lt.qmf_decode(stream_path.read_bytes(), device="cpu"))
    capsys.readouterr()
    assert main(["info", str(stream_path)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["codec"] == "qmf" and info["bytes"] == stream_path.stat().st_size
    assert info["original size"][0] == [64, 96]
    assert info["bit rate (bpp)"] == pytest.approx(8 * info["bytes"] / (64 * 96), abs=1e-3)
    assert main(["--device", "cpu", "eval", str(png), "--quality", "10"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert result["platform"] == "cpu"
    for key in ("compression ratio", "bit rate (bpp)", "PSNR (dB)", "SSIM", "encoding time (ms)"):
        assert key in result


def test_svd_stream_is_detected(png, tmp_path, capsys):
    stream_path, out_path = tmp_path / "img.svd.lrf", tmp_path / "round.png"
    assert main(["--device", "cpu", "encode", str(png), str(stream_path), "--codec", "svd", "--quality", "5"]) == 0
    assert main(["--device", "cpu", "decode", str(stream_path), str(out_path)]) == 0
    np.testing.assert_array_equal(_read(out_path), lt.svd_decode(stream_path.read_bytes(), device="cpu"))
    capsys.readouterr()
    assert main(["info", str(stream_path)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["codec"] == "svd" and "quantization" in info
    assert main(["--device", "cpu", "eval", str(png), "--codec", "svd", "--rank", "4"]) == 0
    assert json.loads(capsys.readouterr().out)["PSNR (dB)"] > 10


@pytest.mark.parametrize("codec", ["qmf", "svd"])
def test_streams_cross_decode_between_the_clis(png, tmp_path, capsys, codec):
    from lrf_tpu.cli import main as jax_main

    flags = ["--codec", codec, "--quality", "7"]
    port_stream, jax_stream = tmp_path / "port.lrf", tmp_path / "jax.lrf"
    assert main(["--device", "cpu", "encode", str(png), str(port_stream), *flags]) == 0
    assert jax_main(["encode", str(png), str(jax_stream), *flags]) == 0
    for stream in (port_stream, jax_stream):
        by_port, by_jax = tmp_path / "by_port.png", tmp_path / "by_jax.png"
        assert main(["--device", "cpu", "decode", str(stream), str(by_port)]) == 0
        assert jax_main(["decode", str(stream), str(by_jax)]) == 0
        _close_pixels(_read(by_port), _read(by_jax))


def test_module_invocation(png, tmp_path):
    stream_path = tmp_path / "img.lrf"
    proc = subprocess.run(
        [sys.executable, "-m", "lrf_tpu_torch", "--device", "cpu", "encode", str(png), str(stream_path),
         "--rank", "4", "--coder", "zlib"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "bytes" in proc.stdout and stream_path.stat().st_size > 0


def test_cuda_device_without_cuda_fails(png, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal path needs a host without it")
    for argv in (["encode", str(png), str(tmp_path / "x.lrf")], ["--device", "cuda", "eval", str(png)]):
        assert main(argv) != 0
        assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "x.lrf").exists()


def test_save_config_writes_jax_text(tmp_path):
    from lrf_tpu.utils.config import read_config as jax_read_config
    from lrf_tpu.utils.config import save_config as jax_save_config

    data = [{"dtype": np.dtype(np.int8), "kind": np.float32, "ranks": np.arange(3, dtype=np.int16),
             "psnr": np.float32(31.25), "n": np.int64(7), "name": "kodim01", "nested": {"q": [1, 2.5]}}]
    lt.save_config(data, save_dir=str(tmp_path / "port"), prefix="qmf")
    jax_save_config(data, save_dir=str(tmp_path / "jax"), prefix="qmf")
    text = (tmp_path / "port" / "qmf_results.json").read_text()
    assert text == (tmp_path / "jax" / "qmf_results.json").read_text()
    back = lt.read_config(str(tmp_path / "port" / "qmf_results.json"))
    assert back == jax_read_config(str(tmp_path / "jax" / "qmf_results.json"))
    assert back[0]["dtype"] == np.dtype(np.int8)
    # torch dtypes and tensors are written as numpy's are
    lt.save_config({"dtype": torch.int8, "ranks": torch.arange(3)}, save_dir=str(tmp_path / "t"), prefix="x")
    assert lt.read_config(str(tmp_path / "t" / "x_results.json")) == {"dtype": np.dtype(np.int8), "ranks": [0, 1, 2]}
    with pytest.raises(FileNotFoundError):
        lt.save_config(data)


@pytest.mark.cuda
def test_cli_encode_launches_the_cluster_kernel_on_gpu(png, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the BCD kernel has no CPU mode)")
    from lrf_tpu_torch.ops import bcd_kernel

    for name in bcd_kernel.KERNEL.counts:
        bcd_kernel.KERNEL.counts[name] = 0
    stream_path = tmp_path / "img.lrf"
    assert main(["encode", str(png), str(stream_path), "--quality", "10"]) == 0
    want = {name: 0 for name in bcd_kernel.KERNEL.counts}
    want["bcd_cluster"] = 3  # Y, Cb, Cr
    assert bcd_kernel.KERNEL.counts == want
    assert stream_path.read_bytes() == lt.qmf_encode(_read(png), quality=10)
