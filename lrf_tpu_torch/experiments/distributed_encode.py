"""Data-parallel dataset encode: every PNG of a directory to a `.qmf` file.

Port of `experiments/distributed_encode.py`, the driver of BASELINE.json's
"Multi-host data-parallel CLIC encode, ordered stream gather"
configuration:

- each image is tiled (`np.tile`) up to `--size` where it is smaller, then
  cropped to its top-left `--size`, so the dataset is one `(N, 3, H, W)`
  batch;
- the batch is encoded by `sharded_qmf_encode_batch` over a data mesh of
  every local CUDA device (`--device cpu`: one CPU device), a ragged batch
  padded up to a device multiple with copies of its first image whose
  streams are dropped;
- with `--multihost` each process (`torch.distributed`, gloo, the `env://`
  variables: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) encodes its
  contiguous slice and the streams are gathered in dataset order
  (`parallel/distributed.py::distributed_encode`);
- process 0 writes `<stem>.qmf` per image into `--out_dir` and prints the
  images, Mpix, seconds, Mpixel/s and the devices over all processes.

    python -m lrf_tpu_torch.experiments distributed_encode --data_dir experiments/data/local7 [--out_dir encoded]
        [--quality 10] [--size 512 768] [--multihost] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from lrf_tpu_torch.experiments.common import dataset_images
from lrf_tpu_torch.parallel.distributed import distributed_encode, initialize, process_count, process_index
from lrf_tpu_torch.parallel.encode import sharded_qmf_encode_batch
from lrf_tpu_torch.parallel.mesh import make_mesh
from lrf_tpu_torch.utils.eval import read_image
from lrf_tpu_torch.utils.transfer import resolve_device

__all__ = ["load_dataset", "local_devices", "encode_dataset", "add_args", "run", "main"]


def load_dataset(paths: Sequence[str], size: tuple[int, int]) -> np.ndarray:
    """`(N, 3, H, W)` uint8: each image tiled up to `size` where it is
    smaller, then its top-left `size` crop."""
    h, w = size
    images = []
    for p in paths:
        img = read_image(p)
        ch, cw = img.shape[-2:]
        if ch < h or cw < w:
            # np.pad(mode="reflect") raises where a pad reaches the image's
            # own size; tiling never does
            img = np.tile(img, (1, -(-h // ch), -(-w // cw)))
        images.append(img[:, :h, :w])
    return np.stack(images)


def local_devices(device: str = "cuda") -> list[str]:
    """Every visible CUDA device (raises without CUDA), or `["cpu"]`."""
    if resolve_device(device).type == "cpu":
        return ["cpu"]
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def encode_dataset(images: np.ndarray, devices: Sequence, quality: float = 10) -> list[bytes]:
    """This process's slice of `images` encoded over a data mesh of
    `devices`, the streams of all processes gathered in dataset order."""
    n_dev = len(devices)
    mesh = make_mesh(data=n_dev, patch=1, devices=list(devices))

    def encode_batch(batch: np.ndarray) -> list[bytes]:
        pad = (-len(batch)) % n_dev
        if pad:
            batch = np.concatenate([batch, batch[:1].repeat(pad, axis=0)])
        streams = sharded_qmf_encode_batch(batch, mesh, quality=quality)
        return streams[: len(streams) - pad] if pad else streams

    return distributed_encode(images, encode_batch)


def _devices_over_processes(n_local: int) -> int:
    if process_count() == 1:
        return n_local
    total = torch.tensor([n_local])
    dist.all_reduce(total)
    return int(total)


def add_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--data_dir", type=str, required=True)
    ap.add_argument("--out_dir", type=str, default="encoded")
    ap.add_argument("--quality", type=float, default=10)
    ap.add_argument("--size", type=int, nargs=2, default=(512, 768),
                    help="common (H, W) to top-left-crop/tile images to")
    ap.add_argument("--multihost", action="store_true",
                    help="one process of several (gloo; MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default: every visible card) or cpu")


def run(args: argparse.Namespace) -> int:
    if args.multihost:
        initialize(init_method="env://")
    paths = dataset_images(args.data_dir)
    if not paths:
        print(f"no PNG images in {args.data_dir}", file=sys.stderr)
        return 2
    h, w = args.size
    images = load_dataset(paths, (h, w))
    devices = local_devices(args.device)

    t0 = time.perf_counter()
    streams = encode_dataset(images, devices, args.quality)
    dt = time.perf_counter() - t0
    n_devices = _devices_over_processes(len(devices))

    if process_index() == 0:
        os.makedirs(args.out_dir, exist_ok=True)
        for path, blob in zip(paths, streams):
            name = os.path.splitext(os.path.basename(path))[0] + ".qmf"
            with open(os.path.join(args.out_dir, name), "wb") as f:
                f.write(blob)
        mpix = images.shape[0] * h * w / 1e6
        print(f"{len(streams)} images, {mpix:.1f} Mpix in {dt:.2f}s = {mpix / dt:.1f} Mpixel/s over "
              f"{n_devices} device(s)", flush=True)
    if args.multihost:
        dist.barrier()  # the other processes wait for process 0's files
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m lrf_tpu_torch.experiments distributed_encode",
                                 description=__doc__.splitlines()[0])
    add_args(ap)
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
