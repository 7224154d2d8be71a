"""The port's evaluation harness and profiling helpers.

- `eval_compression` with the port's `qmf_encode` / `qmf_decode` on a
  96x128 crop on the CPU returns the JAX package's keys; with
  `reconstruct=True` its ratio, bpp, PSNR and SSIM equal, within 1e-5,
  what `lrf_tpu.utils.metrics` computes from the same image, stream and
  reconstruction.
- `device_benchmark` returns the JAX package's keys; `trace` writes a
  Chrome trace; `read_image` reads the repo's PNGs as `(3, H, W)` uint8.
"""

import json
import os

import numpy as np
import pytest
import torch

import lrf_tpu_torch as lt
from torch_images import DATA, kodim01


@pytest.fixture(scope="module")
def crop():
    return np.ascontiguousarray(kodim01()[:, 200:296, 300:428])


def test_eval_compression_matches_jax_keys_and_metrics(crop):
    import lrf_tpu
    from lrf_tpu.utils import metrics as jm

    jax_keys = set(lrf_tpu.eval_compression(crop, lrf_tpu.qmf_encode, lrf_tpu.qmf_decode, quality=10))
    out = lt.eval_compression(crop, lt.qmf_encode, lt.qmf_decode, reconstruct=True, device="cpu", quality=10)
    assert set(out) == jax_keys | {"reconstructed"}
    assert out["platform"] == "cpu" and "encoding device time (ms)" not in out
    assert out["encoding time (ms)"] > 0 and out["decoding time (ms)"] > 0
    stream = lt.qmf_encode(crop, quality=10, device="cpu")
    rec = out["reconstructed"]
    np.testing.assert_array_equal(rec, lt.qmf_decode(stream, device="cpu"))
    want = {
        "compression ratio": jm.compression_ratio(crop, stream),
        "bit rate (bpp)": jm.bits_per_pixel(crop.shape[-2:], stream),
        "PSNR (dB)": float(jm.psnr(crop, rec)),
        "SSIM": float(jm.ssim(crop, rec)),
    }
    for key, value in want.items():
        np.testing.assert_allclose(out[key], value, rtol=1e-5, atol=1e-5 if key == "SSIM" else 0, err_msg=key)
    # a path and an (H, W, C) array are read as the JAX package reads them
    path = os.path.join(DATA, "demo", "kodim01.png")
    small = lt.eval_compression(np.ascontiguousarray(crop.transpose(1, 2, 0)), lt.qmf_encode, lt.qmf_decode,
                                device="cpu", quality=10)
    assert small["bit rate (bpp)"] == out["bit rate (bpp)"] and "reconstructed" not in small
    assert lt.eval_compression(path, lt.qmf_encode, lt.qmf_decode, device="cpu", quality=5)["PSNR (dB)"] > 20


def test_eval_compression_runs_on_the_card_by_default(crop):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal path needs a host without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lt.eval_compression(crop, lt.qmf_encode, lt.qmf_decode, quality=10)


def test_read_image():
    from lrf_tpu.utils.eval import read_image

    path = os.path.join(DATA, "demo", "kodim01.png")
    img = lt.read_image(path)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[0] == 3
    np.testing.assert_array_equal(img, kodim01())
    np.testing.assert_array_equal(img, read_image(path))


def test_device_benchmark_keys():
    calls = []
    out = lt.device_benchmark(lambda x: calls.append(x) or x * 2, torch.ones(4), warmup=1, repeats=3, pixels=10**6)
    assert set(out) == {"mean_ms", "std_ms", "min_ms", "mpixels_per_s"} and len(calls) == 4
    assert 0 <= out["min_ms"] <= out["mean_ms"] and out["std_ms"] >= 0 and out["mpixels_per_s"] > 0
    assert set(lt.device_benchmark(lambda: None, repeats=2)) == {"mean_ms", "std_ms", "min_ms"}


def test_trace_writes_a_chrome_trace(tmp_path):
    with lt.trace(str(tmp_path)) as prof:
        with lt.annotate("lrf encode"):
            lt.sharded_qmf_encode_batch(np.zeros((1, 3, 16, 16), np.uint8), "cpu", 10)
    files = sorted(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.startswith(f"trace_{os.getpid()}_") and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "lrf encode" for e in events)
    assert any("lrf encode" in e.key for e in prof.key_averages())
    with lt.trace(str(tmp_path)):
        pass
    assert len(list(tmp_path.iterdir())) == 2  # a second trace does not overwrite the first
