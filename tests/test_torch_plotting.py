"""The port's LOESS and `Plot` against the JAX package's, on the CPU.

- `LOESS` on numpy-seeded data: degrees 1 and 2, single (frac, degree)
  settings and the frac grid, duplicate abscissae (zero spans: indicator
  weights) and singular neighbourhoods (fewer weighted abscissae than
  coefficients, where every query takes the pseudo-inverse): the same best
  (frac, degree), predictions within 1e-9 (relative, floor 1e-12), or,
  at a query whose normal equations are ill-conditioned, within cond * eps
  of that query's system (no two backward-stable solves agree closer:
  e.g. an extrapolation whose neighbourhood holds two distinct abscissae,
  cond 5.6e9, differed by 5.8e-9).
- `Plot.interpolate` on the stored `experiments/comparison/demo_results.json`
  rows: the same frame as the JAX package's, numbers within 1e-9.
- `Plot.plot` and `save` write a figure under the Agg backend.
- `LOESS(device="cuda")` against `device="cpu"` on the card (`cuda` mark).
"""

import os

import numpy as np
import pytest
import torch

from lrf_tpu_torch.utils import plotting as tplot

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "experiments", "comparison", "demo_results.json")
GRID = np.arange(0.15, 0.75, 0.1)


class _JaxPlotting:
    """`lrf_tpu.utils.plotting`, imported on first use (the `cuda` test runs
    where JAX is absent)."""

    def __getattr__(self, name):
        from lrf_tpu.utils import plotting

        return getattr(plotting, name)


jplot = _JaxPlotting()


def _close(a, b, rtol=1e-9):
    """|a - b| <= rtol |b| + 1e-12, elementwise; `rtol` may be per element."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b)
    bad = ~(err <= rtol * np.abs(b) + 1e-12)
    assert not bad.any(), (a[bad], b[bad], np.broadcast_to(rtol, a.shape)[bad])


def _rtol(model, xq) -> np.ndarray:
    """Per query: 1e-9, or cond * eps of its normal equations where larger
    (the JAX package's weights and basis at the fitted frac and degree)."""
    x = np.asarray(model.x, np.float64)
    k = int(np.ceil(model.best_frac * len(x)))
    w = jplot._tricube_weights(np.abs(xq[:, None] - x[None, :]), k)
    basis = (x[None, :] - xq[:, None])[:, :, None] ** np.arange(int(model.best_degree) + 1)
    gram = np.einsum("qna,qn,qnb->qab", basis, w**2, basis)
    return np.maximum(1e-9, np.linalg.cond(gram) * np.finfo(np.float64).eps)


def _data(seed: int, duplicates: bool):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(12, 45))
    x = np.sort(rng.uniform(0, 1, n))
    if duplicates:
        x[3:7] = x[3]
        x[-3:] = x[-3]
    y = np.sin(3 * x) + rng.normal(0, 0.05, n)
    xq = np.concatenate([np.linspace(-0.05, 1.05, 13), x[3:4]])
    return x, y, xq


@pytest.mark.parametrize("seed", [7, 8, 9])
@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("frac,degree", [(0.2, 1), (0.4, 2), (0.7, 1), (0.7, 2), (GRID, [1, 2])])
def test_loess_matches_jax(seed, duplicates, frac, degree):
    x, y, xq = _data(seed, duplicates)
    j = jplot.LOESS(frac=frac, degree=degree).fit(x, y)
    t = tplot.LOESS(frac=frac, degree=degree, device="cpu").fit(x, y)
    assert (t.best_frac, t.best_degree) == (j.best_frac, j.best_degree)
    pred = t.predict(xq)
    assert pred.dtype == torch.float64 and pred.device.type == "cpu"
    _close(pred.numpy(), j.predict(xq), rtol=_rtol(j, xq))


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("frac", [0.03, 0.05])
def test_loess_singular_neighbourhoods_match_jax(frac, degree):
    # k = ceil(frac * n) leaves each query at most `degree` weighted
    # abscissae (or none): every system is singular, and both packages take
    # the minimum-norm solution for all queries
    x, y, xq = _data(11, duplicates=True)
    j = jplot.LOESS(frac=frac, degree=degree).fit(x, y)
    t = tplot.LOESS(frac=frac, degree=degree, device="cpu").fit(x, y)
    w = tplot._tricube_weights((torch.from_numpy(xq)[:, None] - torch.from_numpy(x)[None, :]).abs(),
                               int(np.ceil(frac * len(x))))
    assert int((w > 0).sum(dim=1).min()) <= degree
    _close(t.predict(xq).numpy(), j.predict(xq))


def test_loess_zero_span_gives_indicator_weights():
    x = torch.tensor([0.0, 0.0, 0.0, 1.0, 2.0], dtype=torch.float64)
    w = tplot._tricube_weights((x[:, None] - x[None, :]).abs(), 2)
    # rows 0-2: span 0, weight 1 on the three zero-distance samples
    assert torch.equal(w[:3], torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0]] * 3, dtype=torch.float64))
    np.testing.assert_allclose(
        w.numpy(), jplot._tricube_weights(np.abs(x.numpy()[:, None] - x.numpy()[None, :]), 2), rtol=0, atol=0
    )


def test_loess_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal path needs a host without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tplot.LOESS(frac=0.3)


def _stored_rows():
    from lrf_tpu.utils.config import read_config

    return read_config(DEMO)


@pytest.mark.parametrize("metric", ["PSNR (dB)", "SSIM", "encoding time (ms)"])
def test_plot_interpolate_matches_jax_on_stored_rows(metric):
    rows = _stored_rows()
    x_values = np.linspace(0.05, 0.5, 19)
    want = jplot.Plot(rows).interpolate(x="bit rate (bpp)", y=metric, x_values=x_values)
    got = tplot.Plot(rows).interpolate(x="bit rate (bpp)", y=metric, x_values=x_values)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    for col in got.columns:
        if col in ("bit rate (bpp)", metric):
            _close(got[col].to_numpy(), want[col].to_numpy())
        else:
            assert got[col].tolist() == want[col].tolist(), col


def test_plot_draws_and_saves(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plot = tplot.Plot(_stored_rows())
    plot.interpolate(x="bit rate (bpp)", y="PSNR (dB)", x_values=np.linspace(0.05, 0.5, 19))
    fig, ax = plot.plot(x="bit rate (bpp)", y="PSNR (dB)", xlim=(0.05, 0.5), legend_labels=("QMF", "JPEG", "SVD"))
    plot.save(save_dir=str(tmp_path), prefix="demo")
    assert (tmp_path / "demo_psnr.pdf").stat().st_size > 0
    assert [t.get_text() for t in ax.get_legend().get_texts()] == ["QMF", "JPEG", "SVD"]
    plt.close(fig)


def test_plot_numeric_groupby(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(3)
    rows = [
        {"data": "a.png", "num_iters": k, "bit rate (bpp)": float(bpp),
         "PSNR (dB)": float(20 + k + 10 * bpp + rng.normal(0, 0.05))}
        for k in (0, 2, 10)
        for bpp in np.linspace(0.08, 0.45, 8)
    ]
    x_values = np.linspace(0.05, 0.5, 8)
    want = jplot.Plot(rows).interpolate(x="bit rate (bpp)", y="PSNR (dB)", groupby="num_iters", x_values=x_values)
    plot = tplot.Plot(rows)
    got = plot.interpolate(x="bit rate (bpp)", y="PSNR (dB)", groupby="num_iters", x_values=x_values)
    _close(got["PSNR (dB)"].to_numpy(), want["PSNR (dB)"].to_numpy())
    fig, ax = plot.plot(x="bit rate (bpp)", y="PSNR (dB)", groupby="num_iters")
    plot.save(save_dir=str(tmp_path), prefix="ablation")
    assert (tmp_path / "ablation_psnr.pdf").exists()
    assert [t.get_text() for t in ax.get_legend().get_texts()] == ["0", "2", "10"]
    plt.close(fig)


@pytest.mark.cuda
def test_loess_on_gpu_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (7, 8):
        x, y, xq = _data(seed, duplicates=seed == 8)
        cpu = tplot.LOESS(frac=GRID, degree=[1, 2], device="cpu").fit(x, y)
        gpu = tplot.LOESS(frac=GRID, degree=[1, 2], device="cuda").fit(x, y)
        assert (gpu.best_frac, gpu.best_degree) == (cpu.best_frac, cpu.best_degree)
        pred = gpu.predict(xq)
        assert pred.is_cuda
        _close(pred.cpu().numpy(), cpu.predict(xq).numpy())
