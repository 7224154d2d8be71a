"""The sweep and ablation harness: the codecs' rate-distortion curves.

Port of the JAX package's experiment layer (`experiments/common.py`, the
comparison and ablation drivers, their aggregates and plots, the dataset
encode driver and the pipeline walkthrough):

- `common`: the JPEG, SVD and QMF sweeps over one image, and
  `run_over_dataset` (results rewritten after every image; a rerun skips
  the images already swept);
- `drivers`: the `eval_image` grids of the comparison and of the bounds,
  num_iters, patch-size and color-space ablations;
- `aggregate`: mean metrics in a bpp window, the published-aggregate
  reproduction and the cross-implementation comparison;
- `plots`: the RD-curve, ablation and collage figures;
- `distributed_encode`: every PNG of a directory encoded over every local
  card and, with `--multihost`, every process;
- `qmf_pipeline`: every stage of the codec walked through on one image.

Command line: ``python -m lrf_tpu_torch.experiments --help``. Sweeps run
on the card unless given ``--device cpu``.
"""
