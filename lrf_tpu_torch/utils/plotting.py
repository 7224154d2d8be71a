"""LOESS smoothing and rate-distortion plotting.

Port of `lrf_tpu/utils/plotting.py`, with the same contract:

- `LOESS`: locally weighted polynomial regression. Tricube weights over
  the k = ceil(frac * n) nearest samples, the k-th distance as the span;
  degree 1 or 2; per-query weighted least squares in which the weight
  enters the residual linearly (so squared in the normal equations); and
  a leave-one-out cross-validated grid search over (frac, degree), the
  first of equal scores in `product(frac, degree)` order winning. It is
  batched float64 tensor math on `device`: a dense query-by-sample tricube
  weight matrix (samples at or past the span weigh exactly 0, so no k-NN
  selection is needed), one batched query-centred normal-equation solve
  (`torch.linalg.solve`, pseudo-inverses where a system is singular), and
  LOOCV in one pass by masking the weight matrix's diagonal.
- `Plot`: group sweep rows by (data, method), LOESS-interpolate each group
  onto a common bpp grid (frac 0.15..0.65 step 0.1, degree 1 or 2), mark
  extrapolated grid points, and draw seaborn line plots with a
  solid/dashed split and standard-error bands. Host analysis over pandas,
  seaborn and matplotlib, imported when called; its LOESS runs on the CPU.

Rows from `lrf_tpu_torch.utils.eval.eval_compression` carry the JAX
package's column names, so either package's stored results plot alike.
"""

from __future__ import annotations

import os
import re
from itertools import product
from typing import Optional, Sequence

import numpy as np
import torch

from lrf_tpu_torch.utils.transfer import resolve_device, to_host

__all__ = ["LOESS", "Plot"]

# numpy's pinv cut-off, relative to the largest singular value
_PINV_RTOL = 1e-15


def _as_f64(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.from_numpy(np.asarray(x, dtype=np.float64).copy()).to(device)


def _tricube_weights(dist: torch.Tensor, k: int) -> torch.Tensor:
    """Dense `(Q, N)` tricube weights for k-nearest-neighbour LOESS.

    Each query row's span is its k-th smallest distance; (1 - (d/span)^3)^3
    vanishes for d >= span, so weighting every sample equals selecting the
    k nearest first. A zero span (duplicate abscissae) leaves indicator
    weights on the zero-distance samples.
    """
    k = min(max(k, 1), dist.shape[1])
    span = torch.kthvalue(dist, k, dim=1, keepdim=True).values
    inf = torch.full_like(dist, float("inf"))
    r = torch.where(span > 0, dist / span, torch.where(dist == 0, torch.zeros_like(dist), inf))
    return torch.clamp(1.0 - r**3, min=0.0) ** 3


def _fit_predict(x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor, x_query: torch.Tensor, degree: int):
    """Batched weighted polynomial fits, one per query: for query q solve
    ``min_beta || W_q (B_q beta - y) ||`` with `B_q` the degree-`degree`
    basis centred at `x_query[q]`, and return each fit's value there (the
    constant coefficient). Where any query's normal equations are singular,
    every query takes the minimum-norm solution (pseudo-inverse), as the
    JAX package's fallback does."""
    t = x[None, :] - x_query[:, None]
    basis = t[:, :, None] ** torch.arange(degree + 1, device=x.device, dtype=x.dtype)
    w2 = weights**2
    gram = torch.einsum("qna,qn,qnb->qab", basis, w2, basis)
    rhs = torch.einsum("qna,qn,n->qa", basis, w2, y)
    coef, info = torch.linalg.solve_ex(gram, rhs[..., None])
    # A query whose nonzero weights cover fewer distinct abscissae than the
    # fit has coefficients has a singular system, whether or not rounding
    # leaves its LU a zero pivot.
    first = ~torch.tril(x[:, None] == x[None, :], diagonal=-1).any(dim=1)
    support = ((weights > 0) & first).sum(dim=1)
    if bool((info != 0).any() or (support < degree + 1).any()):
        coef = torch.linalg.pinv(gram, rtol=_PINV_RTOL) @ rhs[..., None]
    return coef[:, 0, 0]


class LOESS:
    """Locally weighted polynomial regression on `device` (see the module
    docstring). `predict` returns a float64 tensor on `device`."""

    def __init__(self, frac=0.3, degree=1, device="cuda") -> None:
        self.frac = np.atleast_1d(frac)
        self.degree = np.atleast_1d(degree)
        self.device = resolve_device(device)
        self.x: Optional[torch.Tensor] = None
        self.y: Optional[torch.Tensor] = None
        self.best_frac: Optional[float] = None
        self.best_degree: Optional[int] = None

    def fit(self, x, y) -> "LOESS":
        self.x = _as_f64(x, self.device)
        self.y = _as_f64(y, self.device)
        if len(self.frac) > 1 or len(self.degree) > 1:
            self.best_frac, self.best_degree = self._grid_search()
        else:
            self.best_frac, self.best_degree = self.frac[0], self.degree[0]
        return self

    def _grid_search(self):
        best = (np.inf, self.frac[0], self.degree[0])
        for frac, degree in product(self.frac, self.degree):
            score = self._loocv(frac, degree)
            if score < best[0]:
                best = (score, frac, degree)
        return best[1], best[2]

    def _loocv(self, frac: float, degree: int) -> float:
        """Mean squared leave-one-out error in one pass: sample i is held out
        by setting its own distance to infinity (weight 0), with the
        neighbourhood sized k = ceil(frac * (n - 1)), as a refit on the n - 1
        other samples would size it."""
        n = len(self.x)
        if n < 2:
            return np.inf
        dist = (self.x[:, None] - self.x[None, :]).abs()
        dist.fill_diagonal_(float("inf"))
        k = int(np.ceil(frac * (n - 1)))
        w = _tricube_weights(dist, k)
        pred = _fit_predict(self.x, self.y, w, self.x, int(degree))
        return float(torch.mean((self.y - pred) ** 2))

    def predict(self, x_new) -> torch.Tensor:
        x_new = _as_f64(x_new, self.device)
        k = int(np.ceil(self.best_frac * len(self.x)))
        dist = (x_new[:, None] - self.x[None, :]).abs()
        w = _tricube_weights(dist, k)
        return _fit_predict(self.x, self.y, w, x_new, int(self.best_degree))


class Plot:
    """Group-by-interpolate RD curves and seaborn plots of sweep rows."""

    def __init__(self, data, columns: Optional[Sequence[str]] = None) -> None:
        import pandas as pd

        self.data = pd.DataFrame(data, columns=columns)
        self.x: Optional[str] = None
        self.y: Optional[str] = None
        self.x_values = None
        self.fig = None
        self.ax = None

    def interpolate(self, x: str, y: str, x_values, groupby=("data", "method")):
        import pandas as pd

        self.x, self.y, self.x_values = x, y, x_values
        groupby = [groupby] if isinstance(groupby, str) else list(groupby)

        chunks = []
        for keys, grp in self.data.groupby(groupby):
            grp = grp.drop_duplicates(self.x)
            interp = pd.DataFrame({**dict(zip(groupby, keys)), self.x: x_values})
            loess = LOESS(frac=np.arange(0.15, 0.75, 0.1), degree=[1, 2], device="cpu")
            loess.fit(grp[self.x].to_numpy(), grp[self.y].to_numpy())
            interp[self.y] = to_host(loess.predict(x_values))
            x_min, x_max = grp[self.x].min(), grp[self.x].max()
            interp["extrapolated"] = (np.asarray(x_values) < x_min) | (np.asarray(x_values) > x_max)
            chunks.append(interp)
        self.data = pd.concat(chunks)
        return self.data

    def plot(
        self,
        x: str,
        y: str,
        groupby: str = "method",
        errorbar: Optional[str] = "se",
        dashed: bool = True,
        xlim=(None, None),
        ylim=(None, None),
        legend_labels: Optional[Sequence[str]] = None,
    ):
        import matplotlib.pyplot as plt
        import pandas as pd
        import seaborn as sns

        self.x, self.y = x, y
        if self.data[groupby].dtype.kind in "ifub":
            # numeric knobs (num_iters, ...) plot as ordered categories, not
            # a continuous colormap with a subsampled legend
            order = sorted(self.data[groupby].unique())
            self.data = self.data.assign(**{groupby: self.data[groupby].astype(str)})
            if legend_labels is None:
                legend_labels = tuple(str(v) for v in order)
        if legend_labels is None:
            legend_labels = tuple(self.data[groupby].unique())

        if dashed and "extrapolated" in self.data.columns:
            # a grid point is dashed when every row of its group there is extrapolated
            self.data = pd.concat(
                grp.assign(dashed=grp["extrapolated"].all()) for _, grp in self.data.groupby([groupby, self.x])
            )
        else:
            self.data["dashed"] = False

        sns.set_theme(style="white")
        fig, ax = plt.subplots()
        style = dict(marker="o", markersize=5, markeredgewidth=0)
        sns.lineplot(ax=ax, data=self.data[~self.data["dashed"]], x=self.x, y=self.y, hue=groupby,
                     errorbar=errorbar, linestyle="-", legend="brief", **style)
        sns.lineplot(ax=ax, data=self.data, x=self.x, y=self.y, hue=groupby, errorbar=None, linestyle="--",
                     legend=False, **style)
        ax.grid()
        ax.set_xlim(*xlim)
        ax.set_ylim(*ylim)
        handles, labels = ax.get_legend_handles_labels()
        # legend labels come back as strings; groupby values may be numeric
        pairs = [(handles[labels.index(str(lbl))], lbl) for lbl in legend_labels]
        sns.move_legend(ax, "lower right", handles=[p[0] for p in pairs], labels=[p[1] for p in pairs])
        self.fig, self.ax = fig, ax
        return fig, ax

    def save(self, save_dir: str = ".", prefix: str = "", format: str = "pdf") -> None:
        os.makedirs(save_dir, exist_ok=True)
        metric_name = re.sub(r"\s*\(.*?\)\s*", "", self.y).replace(" ", "_")
        self.fig.savefig(
            os.path.join(save_dir, f"{prefix}_{metric_name}.{format}".lower()), bbox_inches="tight", pad_inches=0
        )
