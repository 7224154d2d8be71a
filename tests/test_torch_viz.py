"""The port's visualization helpers against the JAX package's, on the CPU.

- `zscore_normalize` and `minmax_normalize` within 1e-6 of the JAX
  package's over several axes, from arrays and from tensors; they return
  float32 tensors on the input's device.
- `vis_image`, `vis_image_batch` and `vis_collage` give the same number of
  axes, the same visible axes and the same titles as the JAX package's on
  the same inputs (tensors for the port), and save their files.
"""

import numpy as np
import pytest
import torch

from lrf_tpu.utils import viz as jviz
from lrf_tpu_torch.utils import viz as tviz

import torch_images


@pytest.fixture(autouse=True)
def agg():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    yield
    plt.close("all")


@pytest.mark.parametrize("name", ["zscore_normalize", "minmax_normalize"])
@pytest.mark.parametrize("axis", [(-2, -1), -1, 0, (0, 2), (1,)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_normalizations_match_jax(name, axis, as_tensor):
    x = np.random.default_rng(5).normal(3.0, 2.0, size=(4, 6, 7)).astype(np.float64)
    want = getattr(jviz, name)(x, axis=axis)
    got = getattr(tviz, name)(torch.from_numpy(x) if as_tensor else x, axis=axis)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_normalizations_take_integer_images():
    img = torch_images.photos(1, 16, 24, seed=2)[0]
    for name in ("zscore_normalize", "minmax_normalize"):
        want = getattr(jviz, name)(img)
        got = getattr(tviz, name)(torch.from_numpy(img))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _axes_summary(axs):
    axs = np.atleast_1d(axs).ravel()
    return [(ax.axison, ax.get_title(), len(ax.get_images())) for ax in axs]


def test_vis_image_matches_jax(tmp_path):
    img = torch_images.photos(1, 32, 48, seed=1)[0]
    jfig, jax_ax = jviz.vis_image(img, title="crop", save_dir=str(tmp_path / "j"), prefix="img", format="png")
    tfig, port_ax = tviz.vis_image(torch.from_numpy(img), title="crop", save_dir=str(tmp_path / "t"), prefix="img",
                                   format="png")
    assert _axes_summary(port_ax) == _axes_summary(jax_ax)
    assert len(tfig.axes) == len(jfig.axes)
    assert (tmp_path / "t" / "img.png").stat().st_size > 0
    with pytest.raises(ValueError, match="C, H, W"):
        tviz.vis_image(torch.zeros(2, 4, 4))


@pytest.mark.parametrize("shape,multi_channels,grid_size", [
    ((4, 8, 8), False, None),
    ((5, 3, 8, 8), True, None),
    ((2, 3, 1, 8, 8), True, 2),
    ((8, 8), False, None),
])
def test_vis_image_batch_matches_jax(tmp_path, shape, multi_channels, grid_size):
    maps = np.random.default_rng(0).normal(size=shape)
    jfig, jaxs = jviz.vis_image_batch(jviz.minmax_normalize(maps), multi_channels=multi_channels,
                                      grid_size=grid_size, title="maps")
    tfig, taxs = tviz.vis_image_batch(tviz.minmax_normalize(torch.from_numpy(maps)), multi_channels=multi_channels,
                                      grid_size=grid_size, title="maps", save_dir=str(tmp_path), prefix="maps")
    assert _axes_summary(taxs) == _axes_summary(jaxs)
    assert tfig._suptitle.get_text() == jfig._suptitle.get_text() == "maps"
    assert (tmp_path / "maps.pdf").stat().st_size > 0


def test_vis_collage_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    rows = []
    for method in ("QMF", "JPEG", "SVD"):
        for bpp in (0.08, 0.17, 0.31, 0.42):
            rec = rng.integers(0, 256, (3, 16, 24)).astype(np.uint8)
            rows.append({"method": method, "bit rate (bpp)": bpp + rng.normal(0, 0.01),
                         "PSNR (dB)": 20 + 10 * bpp, "reconstructed": rec})
    port_rows = [dict(r, reconstructed=torch.from_numpy(r["reconstructed"])) for r in rows]
    bpps = [0.1, 0.2, 0.3]
    _, jaxs = jviz.vis_collage(rows, bpps, save_dir=str(tmp_path / "j"), prefix="x")
    _, taxs = tviz.vis_collage(port_rows, bpps, save_dir=str(tmp_path / "t"), prefix="x")
    assert np.shape(taxs) == np.shape(jaxs) == (3, 3)
    assert _axes_summary(taxs) == _axes_summary(jaxs)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert (tmp_path / "t" / "x_collage.pdf").stat().st_size > 0
