"""The port's dataset encode driver (`lrf_tpu_torch/experiments/
distributed_encode.py`) against its library call and the JAX package's
driver steps, on the CPU over the seven `experiments/data/local7` PNGs at
`--size 64 96` (every image is larger, so each is cropped).

- The written `<stem>.qmf` files are, in the directory's order, byte-equal
  to `sharded_qmf_encode_batch` of the same cropped images.
- The JAX package's steps (tile, crop, `lrf_tpu.parallel.encode.
  sharded_qmf_encode_batch` on one CPU device) give streams that meet the
  cross-decode contract with the driver's: each package decodes each
  stream to pixels at most 1 apart in under 0.1% of pixels. The streams
  themselves may differ by negated rank components where the init's clip
  penalties tie (ROADMAP queue 3), and at these small stacks that moves
  PSNR: the driver's stream is held to no less than the JAX one's - 0.2 dB.
  It reads higher on every image, by up to 0.5817 dB (parrots_recon_a.png,
  38.0013 against 37.4196 dB), where the JAX package's own per-image encode
  reads 37.2510 dB, 0.17 dB off its batch encode.
- On a 2-device CPU mesh the 7 images go to the encoder as 8 (the first
  repeated) and come back as the 7 one-device streams.
- Run as two gloo processes with `--multihost`, it writes the same files.
- The tile path: a size larger than the image tiles it before the crop.

About 15 s on one core of this host, most of it the JAX compile and the
two processes' start-up.
"""

import glob
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

import lrf_tpu
import lrf_tpu_torch as lt
from lrf_tpu.parallel.encode import sharded_qmf_encode_batch as jax_encode_batch
from lrf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lrf_tpu_torch.experiments import distributed_encode as driver

import torch_images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL7 = os.path.join(ROOT, "experiments", "data", "local7")
SIZE = (64, 96)


def _tile_crop(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """The JAX driver's shaping (`experiments/distributed_encode.py:44-57`)."""
    ch, cw = img.shape[-2:]
    if ch < h or cw < w:
        img = np.tile(img, (1, -(-h // ch), -(-w // cw)))
    return img[:, :h, :w]


@pytest.fixture(scope="module")
def paths():
    found = sorted(glob.glob(os.path.join(LOCAL7, "*.png")))
    assert len(found) == 7
    return found


@pytest.fixture(scope="module")
def images(paths):
    return np.stack([_tile_crop(torch_images.load(p), *SIZE) for p in paths])


@pytest.fixture(scope="module")
def written(tmp_path_factory, paths):
    out = tmp_path_factory.mktemp("encoded")
    argv = ["--data_dir", LOCAL7, "--out_dir", str(out), "--size", *map(str, SIZE), "--device", "cpu"]
    assert driver.main(argv) == 0
    return _read(out, paths)


def _read(out, paths) -> list[bytes]:
    names = sorted(os.listdir(out))
    assert names == sorted(os.path.splitext(os.path.basename(p))[0] + ".qmf" for p in paths)
    blobs = []
    for p in paths:
        with open(os.path.join(out, os.path.splitext(os.path.basename(p))[0] + ".qmf"), "rb") as f:
            blobs.append(f.read())
    return blobs


def test_files_equal_the_batch_encode(written, images):
    assert written == lt.sharded_qmf_encode_batch(images, device="cpu", quality=10)


def test_prints_the_rate_line(tmp_path, capsys):
    argv = ["--data_dir", LOCAL7, "--out_dir", str(tmp_path), "--size", *map(str, SIZE), "--device", "cpu"]
    assert driver.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("7 images, 0.0 Mpix in ") and line.endswith("Mpixel/s over 1 device(s)"), line


def test_cross_decode_with_the_jax_driver(written, images):
    mesh = jax_make_mesh(data=1, patch=1, devices=jax.devices("cpu")[:1])
    jax_streams = jax_encode_batch(images, mesh, quality=10)
    assert len(jax_streams) == len(written) == 7
    for img, s_port, s_jax in zip(images, written, jax_streams):
        for stream in (s_port, s_jax):
            by_jax = np.asarray(lrf_tpu.qmf_decode(stream))
            by_port = lt.qmf_decode(stream, device="cpu")
            assert by_port.shape == img.shape and by_port.dtype == np.uint8
            diff = np.abs(by_jax.astype(np.int16) - by_port.astype(np.int16))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        p_port = float(lt.psnr(img, lt.qmf_decode(s_port, device="cpu")))
        p_jax = float(lt.psnr(img, np.asarray(lrf_tpu.qmf_decode(s_jax))))
        assert p_port > p_jax - 0.2, (p_port, p_jax)


def test_ragged_batch_is_padded_and_dropped(written, images, monkeypatch):
    seen = []
    encode = driver.sharded_qmf_encode_batch

    def spy(batch, mesh, **kw):
        seen.append((batch.copy(), mesh.shape))
        return encode(batch, mesh, **kw)

    monkeypatch.setattr(driver, "sharded_qmf_encode_batch", spy)
    streams = driver.encode_dataset(images, ["cpu", "cpu"], quality=10)
    (batch, shape), = seen
    assert shape == {"data": 2, "patch": 1}
    assert batch.shape[0] == 8
    np.testing.assert_array_equal(batch[:7], images)
    np.testing.assert_array_equal(batch[7], images[0])
    assert streams == written


def test_small_images_are_tiled(paths):
    img = torch_images.load(paths[0])
    h, w = img.shape[-2] + 5, img.shape[-1] * 2 + 3
    got = driver.load_dataset(paths[:1], (h, w))[0]
    assert got.shape == (3, h, w)
    np.testing.assert_array_equal(got[:, : img.shape[-2], : img.shape[-1]], img)
    np.testing.assert_array_equal(got[:, img.shape[-2] :, : img.shape[-1]], img[:, :5])
    np.testing.assert_array_equal(got[:, : img.shape[-2], img.shape[-1] : 2 * img.shape[-1]], img)


def test_no_images_exits_2(tmp_path, capsys):
    assert driver.main(["--data_dir", str(tmp_path), "--device", "cpu"]) == 2
    assert "no PNG images" in capsys.readouterr().err


def test_multihost_two_processes_write_the_same_files(tmp_path, written, paths):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "mh"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE="2")
    argv = [sys.executable, "-m", "lrf_tpu_torch.experiments", "distributed_encode", "--multihost", "--device", "cpu",
            "--data_dir", LOCAL7, "--out_dir", str(out), "--size", *map(str, SIZE)]
    procs = [subprocess.Popen(argv, cwd=ROOT, env=dict(env, RANK=str(rank)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert outs[0][0].strip().endswith("Mpixel/s over 2 device(s)"), outs[0][0]
    assert outs[1][0] == ""
    assert _read(out, paths) == written
