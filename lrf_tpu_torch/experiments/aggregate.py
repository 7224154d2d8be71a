"""Rate-distortion aggregates and cross-implementation comparison tables.

Port of `experiments/comparison/aggregate.py`:

- `aggregate(rows, bpp, metric)`: per method, the mean of `metric` over
  the rows whose bit rate lies within 0.025 bpp of `bpp`;
- `reproduce_published(stored)`: that aggregation over the reference
  repository's stored sweep rows (`stored` maps "kodak" and "clic2024" to
  its `kodak_results.json` and `clic2024_results.json`), printed beside the
  published values (`PUBLISHED`); returns the number of mismatches;
- `compare(ours, theirs)`: per-method deltas between two sweeps of the
  same images at the standard operating points.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

__all__ = ["PUBLISHED", "aggregate", "reproduce_published", "compare"]

# The paper's rate-distortion table: PSNR (dB) or SSIM in the bpp window.
PUBLISHED = {
    ("kodak", 0.2, "PSNR (dB)"): {"QMF": 25.54, "JPEG": 23.65, "SVD": 22.20},
    ("kodak", 0.2, "SSIM"): {"QMF": 0.674, "JPEG": 0.612, "SVD": 0.558},
    ("kodak", 0.3, "PSNR (dB)"): {"QMF": 26.88, "JPEG": 27.82, "SVD": 23.73},
    ("clic2024", 0.2, "PSNR (dB)"): {"QMF": 27.11, "JPEG": 26.48, "SVD": 24.43},
    ("clic2024", 0.3, "PSNR (dB)"): {"QMF": 28.19, "JPEG": 29.97, "SVD": 26.39},
    ("clic2024", 0.2, "SSIM"): {"QMF": 0.740, "JPEG": 0.719, "SVD": 0.660},
}


def aggregate(rows, bpp: float, metric: str, window: float = 0.025) -> dict:
    out = {}
    for method in sorted({r["method"] for r in rows}):
        vals = [r[metric] for r in rows if r["method"] == method and abs(r["bit rate (bpp)"] - bpp) < window]
        if vals:
            out[method] = float(np.mean(vals))
    return out


def reproduce_published(stored: dict) -> int:
    failures = 0
    print("== Published-aggregate reproduction (our analysis on stored rows) ==")
    for (dataset, bpp, metric), expected in PUBLISHED.items():
        with open(stored[dataset]) as f:
            rows = json.load(f)
        got = aggregate(rows, bpp, metric)
        for method, exp_val in expected.items():
            ours = got.get(method, float("nan"))
            # published SSIM has 3 decimals, PSNR 2: allow both sides' rounding
            tol = 0.001 if metric == "SSIM" else 0.01
            ok = abs(ours - exp_val) <= tol + 1e-9
            failures += not ok
            print(
                f"{dataset:9s} @{bpp} bpp {metric:9s} {method:4s}: "
                f"ours {ours:8.3f}  published {exp_val:8.3f}  "
                f"{'OK' if ok else 'MISMATCH'}"
            )
    return failures


def compare(ours_path: str, theirs_path: str, out_path: Optional[str] = None) -> dict:
    with open(ours_path) as f:
        ours = json.load(f)
    with open(theirs_path) as f:
        theirs = json.load(f)
    report = {"ours": ours_path, "reference_impl": theirs_path, "points": []}
    print("== Cross-implementation aggregates (same images, same grids) ==")
    for bpp in (0.15, 0.2, 0.25, 0.3, 0.4):
        for metric in ("PSNR (dB)", "SSIM"):
            a = aggregate(ours, bpp, metric)
            b = aggregate(theirs, bpp, metric)
            for method in sorted(set(a) & set(b)):
                delta = a[method] - b[method]
                report["points"].append(
                    {"bpp": bpp, "metric": metric, "method": method, "ours": a[method],
                     "reference_impl": b[method], "delta": delta}
                )
                print(
                    f"@{bpp:4.2f} bpp {metric:9s} {method:4s}: "
                    f"ours {a[method]:8.4f}  ref-impl {b[method]:8.4f}  "
                    f"delta {delta:+.4f}"
                )
    deltas = [abs(p["delta"]) for p in report["points"] if p["metric"] == "PSNR (dB)"]
    sdeltas = [abs(p["delta"]) for p in report["points"] if p["metric"] == "SSIM"]
    report["max_abs_psnr_delta"] = max(deltas) if deltas else None
    report["max_abs_ssim_delta"] = max(sdeltas) if sdeltas else None
    print(f"max |delta|: PSNR {report['max_abs_psnr_delta']:.4f} dB, SSIM {report['max_abs_ssim_delta']:.5f}")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {out_path}")
    return report
