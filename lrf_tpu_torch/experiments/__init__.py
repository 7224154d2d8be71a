"""The sweep and ablation harness: the codecs' rate-distortion curves.

Port of the JAX package's experiment layer (`experiments/common.py`, the
comparison and ablation drivers, their aggregates and plots):

- `common`: the JPEG, SVD and QMF sweeps over one image, and
  `run_over_dataset` (results rewritten after every image; a rerun skips
  the images already swept);
- `drivers`: the `eval_image` grids of the comparison and of the bounds,
  num_iters, patch-size and color-space ablations;
- `aggregate`: mean metrics in a bpp window, the published-aggregate
  reproduction and the cross-implementation comparison;
- `plots`: the RD-curve, ablation and collage figures.

Command line: ``python -m lrf_tpu_torch.experiments --help``. Sweeps run
on the card unless given ``--device cpu``.
"""
