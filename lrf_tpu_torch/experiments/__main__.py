"""`python -m lrf_tpu_torch.experiments`: the sweeps, their aggregates and figures.

    python -m lrf_tpu_torch.experiments comparison --data_dir experiments/data/local7 --save_dir out --prefix local7
    python -m lrf_tpu_torch.experiments {bounds,numiters,patchsize,colorspace} --data_dir DIR [--device cpu]
    python -m lrf_tpu_torch.experiments plot --results out/local7_results.json --save_dir figs
    python -m lrf_tpu_torch.experiments ablation_plot --results R.json --groupby bounds
    python -m lrf_tpu_torch.experiments collage --image experiments/data/local7/parrots_recon_a.png
    python -m lrf_tpu_torch.experiments aggregate --ours A.json --theirs B.json
    python -m lrf_tpu_torch.experiments distributed_encode --data_dir experiments/data/local7 [--multihost]
    python -m lrf_tpu_torch.experiments pipeline [--image experiments/data/demo/kodim01.png] [--quality 7]

A sweep writes `{save_dir}/{prefix}_results.json` after every image and,
run again, resumes where it stopped. Sweeps and the collage run on the
card unless given `--device cpu`; the figures need matplotlib, pandas and
seaborn. So do the dataset encode (`distributed_encode`: every PNG of a
directory to `<stem>.qmf`, over every local card and, with `--multihost`,
every process) and the walkthrough (`pipeline`: every stage of the codec
on one image, its figures drawn where matplotlib is installed).
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

from lrf_tpu_torch.experiments import aggregate as agg
from lrf_tpu_torch.experiments import distributed_encode, qmf_pipeline
from lrf_tpu_torch.experiments.common import add_driver_args, dataset_images, resolve_args, run_over_dataset
from lrf_tpu_torch.experiments.drivers import DRIVERS


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m lrf_tpu_torch.experiments", description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)
    for name, (_, save_dir, description) in DRIVERS.items():
        add_driver_args(sub.add_parser(name, help=description, description=description), save_dir)
    p = sub.add_parser("plot", help="RD curves of a comparison sweep")
    p.add_argument("--results", required=True)
    p.add_argument("--save_dir", default=".")
    p.add_argument("--prefix", default="comparison")
    p = sub.add_parser("ablation_plot", help="RD curves of an ablation, grouped by its parameter")
    p.add_argument("--results", required=True)
    p.add_argument("--groupby", required=True)
    p.add_argument("--metric", default="PSNR (dB)")
    p.add_argument("--save_dir", default=".")
    p.add_argument("--prefix", default="ablation")
    p = sub.add_parser("collage", help="method x bpp collage of one image")
    p.add_argument("--image", default=os.path.join("experiments", "data", "local7", "parrots_recon_a.png"))
    p.add_argument("--bpps", type=float, nargs="+", default=[0.1, 0.2, 0.3])
    p.add_argument("--out", default="collage")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p = sub.add_parser("aggregate", help="aggregates at the standard bpp points")
    p.add_argument("--reproduce-published", metavar="DIR",
                   help="the reference repository's experiments/comparison directory (kodak_results.json, "
                        "clic2024_results.json)")
    p.add_argument("--ours")
    p.add_argument("--theirs")
    p.add_argument("--out")
    distributed_encode.add_args(sub.add_parser("distributed_encode", help="encode every PNG of a directory over "
                                               "every local card (and process)"))
    qmf_pipeline.add_args(sub.add_parser("pipeline", help="every stage of the codec on one image"))
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.command in DRIVERS:
        args = resolve_args(args)
        if not dataset_images(args.data_dir):
            print(f"no PNG images in {args.data_dir}", file=sys.stderr)
            return 2
        per_image = functools.partial(DRIVERS[args.command][0], device=args.device)
        run_over_dataset(args.data_dir, per_image, args.save_dir, args.prefix)
        return 0
    if args.command == "distributed_encode":
        return distributed_encode.run(args)
    if args.command == "pipeline":
        return qmf_pipeline.run(args)
    if args.command == "plot":
        from lrf_tpu_torch.experiments.plots import plot_comparison

        plot_comparison(args.results, args.save_dir, args.prefix)
        return 0
    if args.command == "ablation_plot":
        from lrf_tpu_torch.experiments.plots import plot_ablation

        plot_ablation(args.results, args.groupby, args.metric, args.save_dir, args.prefix)
        return 0
    if args.command == "collage":
        from lrf_tpu_torch.experiments.plots import collage

        print(f"wrote {collage(args.image, args.bpps, args.out, args.device)} (and each cell's image)")
        return 0
    rc = 0
    if args.reproduce_published:
        stored = {d: os.path.join(args.reproduce_published, f"{d}_results.json") for d in ("kodak", "clic2024")}
        rc = agg.reproduce_published(stored)
    if args.ours and args.theirs:
        agg.compare(args.ours, args.theirs, args.out)
    return 1 if rc else 0


if __name__ == "__main__":
    raise SystemExit(main())
