"""The port's QMF walkthrough (`lrf_tpu_torch/experiments/qmf_pipeline.py`)
against the JAX package's script (`experiments/examples/qmf_pipeline.py`),
on the CPU, on the 256x384 crop at rows 128-383, columns 192-575 of
`experiments/data/demo/kodim01.png`, at quality 7.

- The stages against the JAX script's computations: equal metadata, equal
  color planes within 1e-3 (float32 color transforms), bpp within 0.5%
  (the fiber coders of the two packages may frame a few bytes apart: 3032
  against 3031 bytes here), the first four rank-1 terms' energy fractions
  within 1e-3, PSNR within 0.01 dB and SSIM within 1e-3.
- Both scripts run whole: the port's prints the JAX script's metadata and
  energy lines, and both draw the same five figures (`y`, `cb`, `u_maps`,
  `v_maps`, `recon`, PNG).
- `--device cuda` raises without CUDA (`tests/test_torch_guard.py`).

About 15 s on one core of this host, most of it drawing the ten figures.
"""

import contextlib
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

import lrf_tpu
from lrf_tpu.models.container import bytes_to_dict, decode_tensor, separate_bytes
from lrf_tpu_torch.experiments import qmf_pipeline

import torch_images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = 7


@pytest.fixture(scope="module")
def crop():
    return np.ascontiguousarray(torch_images.kodim01()[:, 128:384, 192:576])


@pytest.fixture(scope="module")
def crop_png(crop, tmp_path_factory):
    path = tmp_path_factory.mktemp("img") / "crop.png"
    Image.fromarray(crop.transpose(1, 2, 0)).save(path)
    return str(path)


def _jax_stages(image):
    """The JAX script's computations (`qmf_pipeline.py:48-86`), no figures."""
    ycbcr = np.asarray(lrf_tpu.rgb_to_ycbcr(image))
    y, cb, _ = lrf_tpu.chroma_downsample(ycbcr)
    encoded = lrf_tpu.qmf_encode(image, quality=QUALITY)
    meta = bytes_to_dict(separate_bytes(encoded, 2)[0])
    blobs = separate_bytes(separate_bytes(encoded, 2)[1], 6)
    u = decode_tensor(blobs[0]).astype(np.float32)
    v = decode_tensor(blobs[1]).astype(np.float32)
    terms = np.stack([np.outer(u[:, r], v[:, r]).reshape(-1) for r in range(min(4, u.shape[1]))])
    decoded = lrf_tpu.qmf_decode(encoded)
    return {
        "y": np.asarray(y), "cb": np.asarray(cb), "metadata": meta,
        "bpp": lrf_tpu.bits_per_pixel(image.shape[-2:], encoded),
        "energy": (terms**2).sum(axis=1) / (terms**2).sum(),
        "psnr": float(lrf_tpu.psnr(image, decoded)), "ssim": float(lrf_tpu.ssim(image, decoded)),
    }


def test_stages_match_the_jax_script(crop):
    got = qmf_pipeline.stages(crop, QUALITY, device="cpu")
    want = _jax_stages(crop)
    assert got["metadata"] == want["metadata"]
    for plane in ("y", "cb"):
        assert got[plane].shape == want[plane].shape
        np.testing.assert_allclose(got[plane], want[plane], atol=1e-3, rtol=0)
    assert abs(got["bpp"] / want["bpp"] - 1) < 5e-3, (got["bpp"], want["bpp"])
    np.testing.assert_allclose(got["energy"], want["energy"], atol=1e-3, rtol=0)
    assert abs(got["psnr"] - want["psnr"]) < 0.01, (got["psnr"], want["psnr"])
    assert abs(got["ssim"] - want["ssim"]) < 1e-3, (got["ssim"], want["ssim"])
    r = got["metadata"]["rank"][0]
    assert got["u_map"].shape == (r, 1, 256 // 8, 384 // 8) and got["v_map"].shape == (r, 1, 8, 8)
    assert got["decoded"].shape == crop.shape and got["decoded"].dtype == np.uint8
    assert list(got["seconds"]) == ["color", "encode", "parse", "factor maps", "rank-1 terms", "decode", "metrics"]


def _run_jax_script(argv) -> str:
    spec = importlib.util.spec_from_file_location(
        "jax_qmf_pipeline", os.path.join(ROOT, "experiments", "examples", "qmf_pipeline.py"))
    module = importlib.util.module_from_spec(spec)
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["qmf_pipeline.py", *argv]
    try:
        spec.loader.exec_module(module)
        with contextlib.redirect_stdout(out):
            module.main()
    finally:
        sys.argv = saved
    return out.getvalue()


def test_both_scripts_print_and_draw_alike(crop_png, tmp_path):
    jax_out = _run_jax_script(["--image", crop_png, "--quality", str(QUALITY), "--save_dir", str(tmp_path / "jax")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert qmf_pipeline.main(["--image", crop_png, "--quality", str(QUALITY), "--save_dir", str(tmp_path / "port"),
                                  "--device", "cpu"]) == 0
    port_lines, jax_lines = out.getvalue().splitlines(), jax_out.splitlines()
    for prefix in ("metadata:", "first rank-1 term energy fractions:"):
        assert [l for l in port_lines if l.startswith(prefix)] == [l for l in jax_lines if l.startswith(prefix)]
    assert any(l.startswith("PSNR: ") for l in port_lines)
    assert any(l.startswith("stage times (ms, on cpu): color ") for l in port_lines)
    figures = sorted(f"{name}.png" for name in qmf_pipeline.FIGURES)
    assert sorted(os.listdir(tmp_path / "jax")) == figures
    assert sorted(os.listdir(tmp_path / "port")) == figures
    for name in figures:
        assert os.path.getsize(tmp_path / "port" / name) > 0
