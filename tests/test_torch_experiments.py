"""The port's sweep and ablation harness against the JAX package's, on the CPU.

The JAX side is `experiments/common.py` and its drivers, imported as
`tests/test_experiments.py` imports them, with `LRF_TPU_PLATFORM=cpu` set
first (so `common.py` pins the CPU and sets no persistent compile cache).

- Sweep rows on a 64x96 crop: the same keys in the same order and the
  same parameters. JPEG: the same bytes (bpp, compression ratio), PSNR and
  SSIM within the metrics' contract (1e-5; each package sums in float32
  its own way). QMF, at q10 and q40: PSNR within 0.2 dB, the contract of
  `test_torch_qmf.py::test_cross_decode_and_rd`; at q10 also streams at
  most 2 bytes apart and PSNR within 1e-3 dB. (At q40 the integer sweeps
  from two inits that differ in their last bits part further: 1-21 bytes
  and up to 0.02 dB on three such crops.) SVD, at two qualities: with the
  JAX package's singular-vector signs, PSNR within 0.1 dB, the contract of
  `test_torch_svd_codec.py`.
- The five drivers' grids: with `eval_compression` stubbed in both
  packages, each `eval_image` gives the JAX driver's rows (method,
  encoder, every parameter), in order.
- `run_over_dataset`: checkpoint after every image, resume, and the same
  results file as the JAX package's.
- `aggregate`, `reproduce_published` (fed the stored sweeps in the repo)
  and `compare` give the JAX package's numbers and printout.
- The command line: `--help`, the figures from stored results, a driver on
  the CPU, and no sweep without `--device cpu` where there is no CUDA.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lrf_tpu_torch
from lrf_tpu_torch.experiments import aggregate as tagg
from lrf_tpu_torch.experiments import common as tcommon
from lrf_tpu_torch.experiments import drivers as tdrivers
from lrf_tpu_torch.experiments.__main__ import main as cli_main

import torch_images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = os.path.join(ROOT, "experiments")
STORED = {
    "local7": os.path.join(EXPERIMENTS, "comparison", "local7_results.json"),
    "local7 reference": os.path.join(EXPERIMENTS, "comparison", "local7_reference_results.json"),
    "demo": os.path.join(EXPERIMENTS, "comparison", "demo_results.json"),
}
METRICS = ("compression ratio", "bit rate (bpp)", "PSNR (dB)", "SSIM", "encoding time (ms)", "decoding time (ms)")
JAX_DRIVERS = {
    "comparison": "comparison/eval.py",
    "bounds": "ablation_bounds/eval.py",
    "numiters": "ablation_numiters/eval.py",
    "patchsize": "ablation_patchsize/eval.py",
    "colorspace": "ablation_colorspace/eval.py",
}


@pytest.fixture
def jcommon(monkeypatch):
    monkeypatch.setenv("LRF_TPU_PLATFORM", "cpu")
    monkeypatch.syspath_prepend(EXPERIMENTS)
    return importlib.import_module("common")


def _load(name: str, relpath: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXPERIMENTS, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def crop():
    return torch_images.photos(1, 64, 96, seed=0)[0]


def _params(row):
    return {k: v for k, v in row.items() if k not in METRICS and k != "platform"}


def _same_schema(jax_rows, port_rows):
    assert len(port_rows) == len(jax_rows)
    for a, b in zip(jax_rows, port_rows):
        assert list(b.keys()) == list(a.keys())
        assert _params(b) == _params(a)
        assert a["platform"] == b["platform"] == "cpu"


def test_sweep_jpeg_rows(jcommon, crop):
    want = jcommon.sweep_jpeg(crop, "x.png", qualities=[10, 50])
    got = tcommon.sweep_jpeg(crop, "x.png", qualities=[10, 50], device="cpu")
    _same_schema(want, got)
    for a, b in zip(want, got):
        assert (b["bit rate (bpp)"], b["compression ratio"]) == (a["bit rate (bpp)"], a["compression ratio"])
        assert abs(b["PSNR (dB)"] - a["PSNR (dB)"]) <= 1e-5 * a["PSNR (dB)"]
        assert abs(b["SSIM"] - a["SSIM"]) <= 1e-5


def test_sweep_qmf_rows(jcommon, crop):
    want = jcommon.sweep_qmf(crop, "x.png", qualities=[10.0, 40.0])
    got = tcommon.sweep_qmf(crop, "x.png", qualities=[10.0, 40.0], device="cpu")
    _same_schema(want, got)
    pixels = crop.shape[1] * crop.shape[2]
    for a, b in zip(want, got):
        d_psnr = b["PSNR (dB)"] - a["PSNR (dB)"]
        d_bytes = (b["bit rate (bpp)"] - a["bit rate (bpp)"]) * pixels / 8
        print(f"QMF q{a['quality'][0]}: {d_bytes:+.0f} B, {d_psnr:+.6f} dB")
        assert abs(d_psnr) < 0.2
        if a["quality"][0] == 10.0:
            assert abs(d_bytes) <= 2 and abs(d_psnr) <= 1e-3


def test_sweep_svd_rows(jcommon, crop, monkeypatch):
    import jax.numpy as jnp

    from lrf_tpu.ops import svd as jsvd
    from lrf_tpu_torch.models import svd as psvd

    port_factors = psvd._balanced_factors

    def with_jax_signs(x, rank):
        u, v = port_factors(x, rank)
        u_j = torch.from_numpy(np.asarray(jsvd.svd_balanced_factors(jnp.asarray(x.numpy()), rank, method="svd")[0]))
        sign = torch.where((u * u_j).sum(-2) < 0, -1.0, 1.0)[..., None, :]
        return u * sign, v * sign

    want = jcommon.sweep_svd(crop, "x.png", qualities=[1.0, 3.0])
    raw = tcommon.sweep_svd(crop, "x.png", qualities=[1.0, 3.0], device="cpu")
    monkeypatch.setattr(psvd, "_balanced_factors", with_jax_signs)  # every sign the JAX package's
    got = tcommon.sweep_svd(crop, "x.png", qualities=[1.0, 3.0], device="cpu")
    _same_schema(want, raw)
    _same_schema(want, got)
    for a, b, r in zip(want, got, raw):
        print(f"SVD q{a['quality']}: own signs {r['PSNR (dB)'] - a['PSNR (dB)']:+.6f} dB, "
              f"the JAX package's {b['PSNR (dB)'] - a['PSNR (dB)']:+.6f} dB")
        assert abs(b["PSNR (dB)"] - a["PSNR (dB)"]) < 0.1


class _Recorder:
    """An `eval_compression` stub: records each call's codec and keyword
    arguments (but `device`) and returns no metrics."""

    names = {"pil_encode": "jpeg", "_jpeg_encode": "jpeg", "qmf_encode": "qmf", "svd_encode": "svd"}

    def __init__(self):
        self.calls = []

    def __call__(self, image, encoder, decoder, reconstruct=False, device=None, **kwargs):
        self.calls.append((self.names[encoder.__name__], kwargs))
        return {}


@pytest.mark.parametrize("name", sorted(JAX_DRIVERS))
def test_driver_grids_match_jax(jcommon, monkeypatch, name):
    jax_driver = _load(f"jax_driver_{name}", JAX_DRIVERS[name])
    jax_rec, port_rec = _Recorder(), _Recorder()
    monkeypatch.setattr(jcommon, "eval_compression", jax_rec)
    if hasattr(jax_driver, "eval_compression"):
        monkeypatch.setattr(jax_driver, "eval_compression", jax_rec)
    monkeypatch.setattr(tcommon, "eval_compression", port_rec)
    monkeypatch.setattr(tdrivers, "eval_compression", port_rec)
    image = np.zeros((3, 8, 8), np.uint8)
    want = jax_driver.eval_image(image, "a.png")
    got = tdrivers.DRIVERS[name][0](image, "a.png", device="cpu")
    assert got == want
    assert port_rec.calls == jax_rec.calls
    assert len(got) == {"comparison": 185, "bounds": 320, "numiters": 400, "patchsize": 400, "colorspace": 130}[name]


def _pngs(directory, n: int = 3):
    from PIL import Image

    directory.mkdir()
    for i, img in enumerate(torch_images.photos(n, 16, 16, seed=6)):
        Image.fromarray(np.ascontiguousarray(img.transpose(1, 2, 0))).save(directory / f"{'abc'[i]}.png")


def test_run_over_dataset_checkpoints_and_resumes(jcommon, tmp_path):
    _pngs(tmp_path / "data")
    calls = []

    def per_image(image, image_id):
        calls.append(image_id)
        if image_id == "c.png" and calls.count("c.png") == 1:
            raise RuntimeError("simulated crash")
        return [{"data": image_id, "method": "X", "PSNR (dB)": float(image.mean()), "dtype": np.int8}]

    with pytest.raises(RuntimeError):
        tcommon.run_over_dataset(str(tmp_path / "data"), per_image, str(tmp_path / "port"), "ck", verbose=False)
    partial = lrf_tpu_torch.read_config(str(tmp_path / "port" / "ck_results.json"))
    assert {r["data"] for r in partial} == {"a.png", "b.png"}
    results = tcommon.run_over_dataset(str(tmp_path / "data"), per_image, str(tmp_path / "port"), "ck", verbose=False)
    assert [r["data"] for r in results] == ["a.png", "b.png", "c.png"]
    assert calls == ["a.png", "b.png", "c.png", "c.png"]
    # a finished dataset sweeps nothing more
    assert tcommon.run_over_dataset(str(tmp_path / "data"), per_image, str(tmp_path / "port"), "ck",
                                    verbose=False) == results
    assert len(calls) == 4
    # the JAX package writes the same file for the same rows
    jcommon.run_over_dataset(str(tmp_path / "data"), lambda image, image_id: per_image(image, image_id),
                             str(tmp_path / "jax"), "ck", verbose=False)
    assert (tmp_path / "port" / "ck_results.json").read_text() == (tmp_path / "jax" / "ck_results.json").read_text()


def _jax_aggregate():
    return _load("jax_aggregate", "comparison/aggregate.py")


@pytest.mark.parametrize("stored", ["local7", "demo", "local7 reference"])
def test_aggregate_matches_jax(stored):
    jagg = _jax_aggregate()
    with open(STORED[stored]) as f:
        rows = json.load(f)
    for bpp in (0.1, 0.15, 0.2, 0.25, 0.3, 0.4):
        for metric in ("PSNR (dB)", "SSIM", "encoding time (ms)"):
            assert tagg.aggregate(rows, bpp, metric) == jagg.aggregate(rows, bpp, metric)
    assert tagg.PUBLISHED == jagg.PUBLISHED


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


def test_reproduce_published_and_compare_match_jax(monkeypatch, tmp_path):
    jagg = _jax_aggregate()
    stored = {"kodak": STORED["local7"], "clic2024": STORED["demo"]}
    monkeypatch.setattr(jagg, "REF_STORED", stored)
    want = _printed(jagg.reproduce_published)
    got = _printed(tagg.reproduce_published, stored)
    assert got == want and want[0] > 0  # these are not the published datasets
    want = _printed(jagg.compare, STORED["local7"], STORED["local7 reference"], str(tmp_path / "j.json"))
    got = _printed(tagg.compare, STORED["local7"], STORED["local7 reference"], str(tmp_path / "t.json"))
    assert got[0] == dict(want[0]) and got[1].replace("t.json", "j.json") == want[1]


def test_cli_help():
    proc = subprocess.run([sys.executable, "-m", "lrf_tpu_torch.experiments", "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for command in (*tdrivers.DRIVERS, "plot", "ablation_plot", "collage", "aggregate"):
        assert command in proc.stdout
        with pytest.raises(SystemExit) as exc, contextlib.redirect_stdout(io.StringIO()) as out:
            cli_main([command, "--help"])
        assert exc.value.code == 0 and "usage" in out.getvalue()
        assert ("--device" in out.getvalue()) == (command in (*tdrivers.DRIVERS, "collage"))


def test_default_argparser_matches_jax(jcommon, monkeypatch):
    for argv in ([], ["--data", "local7"], ["--data_dir", "d", "--prefix", "p", "--save_dir", "s"]):
        monkeypatch.setattr(sys, "argv", ["eval.py", *argv])
        want = vars(jcommon.default_argparser("x", "out"))
        got = vars(tcommon.default_argparser("x", "out", argv))
        assert got.pop("device") == "cuda"
        if "--data_dir" not in argv:  # the JAX drivers run from experiments/<driver>/
            assert want.pop("data_dir") == f"../data/{want['data']}"
            assert got.pop("data_dir") == os.path.join("experiments", "data", got["data"])
        assert got == want


def test_cli_figures_from_stored_results(tmp_path):
    import matplotlib.pyplot as plt

    assert cli_main(["plot", "--results", STORED["demo"], "--save_dir", str(tmp_path), "--prefix", "demo"]) == 0
    plt.close("all")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "demo_decoding_time.pdf", "demo_encoding_time.pdf", "demo_psnr.pdf", "demo_ssim.pdf"]
    bounds = os.path.join(EXPERIMENTS, "ablation_bounds", "demo_results.json")
    assert cli_main(["ablation_plot", "--results", bounds, "--groupby", "bounds", "--save_dir", str(tmp_path / "b"),
                     "--prefix", "bounds"]) == 0
    plt.close("all")
    assert (tmp_path / "b" / "bounds_psnr.pdf").stat().st_size > 0
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli_main(["aggregate", "--ours", STORED["local7"], "--theirs", STORED["local7 reference"]]) == 0
    assert "max |delta|" in out.getvalue()


def test_cli_driver_on_cpu_and_refusal_without_cuda(tmp_path):
    _pngs(tmp_path / "data", n=2)
    args = ["colorspace", "--data_dir", str(tmp_path / "data"), "--save_dir", str(tmp_path / "out"), "--prefix", "t"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli_main(args + ["--device", "cpu"]) == 0
    rows = lrf_tpu_torch.read_config(str(tmp_path / "out" / "t_results.json"))
    assert [r["data"] for r in rows] == ["a.png"] * 130 + ["b.png"] * 130
    assert {r["color_space"] for r in rows} == {"RGB", "YCbCr"} and {r["platform"] for r in rows} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main(args[:-1] + ["other"])
        assert not (tmp_path / "out" / "other_results.json").exists()
    assert cli_main(["bounds", "--data_dir", str(tmp_path / "empty"), "--device", "cpu"]) == 2


def test_collage_on_cpu(tmp_path):
    from PIL import Image

    from lrf_tpu_torch.experiments import plots

    path = tmp_path / "img.png"
    Image.fromarray(np.ascontiguousarray(torch_images.photos(1, 24, 32, seed=9)[0].transpose(1, 2, 0))).save(path)
    out = plots.collage(str(path), (0.5, 1.5), out=str(tmp_path / "collage"), device="cpu")
    assert os.path.basename(out) == "img_collage.pdf" and os.path.getsize(out) > 0
    # a 24x32 image's streams are mostly header: each method's lowest rate
    # is nearest both targets, so one cell image per method
    cells = sorted(p.name.split("_bpp")[0] for p in (tmp_path / "collage").iterdir() if p.name != "img_collage.pdf")
    assert cells == ["img_jpeg", "img_qmf", "img_svd"]


@pytest.mark.cuda
def test_one_sweep_row_per_method_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    crop = torch_images.photos(1, 128, 192, seed=0)[0]
    for sweep, q, in ((tcommon.sweep_jpeg, 30), (tcommon.sweep_svd, 1.5), (tcommon.sweep_qmf, 20.0)):
        (card,) = sweep(crop, "x.png", qualities=[q], device="cuda")
        (cpu,) = sweep(crop, "x.png", qualities=[q], device="cpu")
        assert list(card) == list(cpu) + ["encoding device time (ms)"]
        device_ms = card.pop("encoding device time (ms)")
        assert card["platform"].startswith("cuda") and device_ms > 0 and _params(card) == _params(cpu)
        assert abs(card["bit rate (bpp)"] / cpu["bit rate (bpp)"] - 1) < 0.01
        assert abs(card["PSNR (dB)"] - cpu["PSNR (dB)"]) < 0.2 and abs(card["SSIM"] - cpu["SSIM"]) < 5e-3
