"""The codec's single encode step, and a dry run of the sharded codec.

Port of the JAX package's `__graft_entry__.py`:

- `entry(device)` returns `(forward, (image,))`: `forward` is the QMF
  encode core of one Kodak-size (3, 512, 768) uint8 image (color
  transform, chroma downsample, reflect pad, 8x8 patchify, SVD init and 10
  BCD sweeps at ranks (13, 6, 6), the quality-20 schedule, within bounds
  (-16, 15)) and returns the six int8 factors (U, V of Y, Cb, Cr). On the
  card each channel's sweeps run in the BCD kernel its shape plans: three
  `bcd_cluster` launches.
- `dryrun_multichip(n_devices, devices)` runs the sharded encode and
  decode on small photographic stand-ins over an n-device mesh and raises
  when a check fails: a `(data, patch)` mesh encode at 32x48 against the
  per-image codec (PSNR within 0.2 dB), the sharded decode on that mesh
  against per-image decodes (bit-equal), and a data-only mesh at 64x96
  with the BCD kernel against the plain sweeps (PSNR within 0.2 dB).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from lrf_tpu_torch.utils.transfer import resolve_device

__all__ = ["RANKS", "entry", "dryrun_multichip"]

RANKS = (13, 6, 6)  # the quality-20 schedule at 512x768


def entry(device="cuda"):
    """`(forward, (image,))` with `image` the seeded (3, 512, 768) uint8
    tensor on `device`."""
    from lrf_tpu_torch.ops.bcd import qmf_decompose
    from lrf_tpu_torch.ops.color import rgb_to_ycbcr
    from lrf_tpu_torch.ops.pad import pad_image
    from lrf_tpu_torch.ops.patch import patchify
    from lrf_tpu_torch.ops.resample import chroma_downsample

    device = resolve_device(device)

    def forward(image: torch.Tensor) -> tuple[torch.Tensor, ...]:
        ycbcr = rgb_to_ycbcr(image.to(torch.float32))
        channels = chroma_downsample(ycbcr, (0.5, 0.5))
        factors = []
        for channel, rank in zip(channels, RANKS):
            xm = patchify(pad_image(channel, (8, 8)), (8, 8))
            u, v, _ = qmf_decompose(xm, rank=rank, num_iters=10, bounds=(-16, 15), factor=(0, 1))
            factors.append(u.to(torch.int8))
            factors.append(v.to(torch.int8))
        return tuple(factors)

    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.integers(0, 256, (3, 512, 768)).astype(np.uint8)).to(device)
    return forward, (image,)


def structured_images(n: int, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """`(n, 3, h, w)` uint8 stand-ins with photographic statistics: smooth
    fields, an edge and light noise. On pure noise the BCD sweeps barely
    improve on the SVD init, and the PSNR checks would see no fault."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = []
    for i in range(n):
        base = (
            110
            + 70 * np.sin(2 * np.pi * (xx / (20 + 7 * i) + yy / (31 + 5 * i)))
            + 50 * (xx > (w // 2 + 3 * i))
            + 25 * np.cos(2 * np.pi * yy / (11 + 3 * i))
        )
        chans = [base + 18 * c + rng.normal(0, 6, (h, w)) for c in range(3)]
        imgs.append(np.clip(np.stack(chans), 0, 255).astype(np.uint8))
    return np.stack(imgs)


def _default_devices(n_devices: int) -> list[str]:
    """The first `n_devices` cards, or `cuda:0` repeated where there are fewer."""
    resolve_device("cuda")
    if torch.cuda.device_count() >= n_devices:
        return [f"cuda:{i}" for i in range(n_devices)]
    return ["cuda:0"] * n_devices


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> None:
    """The sharded encode and decode over an `n_devices` mesh of `devices`
    (default: the visible cards, or `cuda:0` repeated); raises on a failed
    check."""
    from lrf_tpu_torch.models.qmf import qmf_decode, qmf_encode
    from lrf_tpu_torch.parallel.decode import sharded_qmf_decode_batch
    from lrf_tpu_torch.parallel.encode import sharded_qmf_encode_batch
    from lrf_tpu_torch.parallel.mesh import make_mesh
    from lrf_tpu_torch.utils.metrics import psnr

    devices = list(_default_devices(n_devices) if devices is None else devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    rng = np.random.default_rng(0)

    def psnr_of(ref: np.ndarray, stream: bytes, device) -> float:
        return float(psnr(torch.from_numpy(ref), torch.from_numpy(qmf_decode(stream, device=device))))

    # 1. (data, patch) mesh: the batch over data rows, each stack's rows over
    # the patch shards (the sums over M taken across them).
    patch = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(data=n_devices // patch, patch=patch, devices=devices)
    first = mesh.first
    batch = structured_images(n_devices // patch * 2, 32, 48, rng)
    streams = sharded_qmf_encode_batch(batch, mesh, quality=20, num_iters=2)
    if len(streams) != batch.shape[0] or not all(isinstance(s, bytes) and s for s in streams):
        raise AssertionError("the mesh encode returned no stream for some image")
    # Split sums over M may flip a round() at a tie, so the per-image codec
    # is held at the decoded-PSNR level, not byte for byte.
    single = qmf_encode(batch[0], quality=20, num_iters=2, device=first)
    p_single, p_shard = psnr_of(batch[0], single, first), psnr_of(batch[0], streams[0], first)
    if abs(p_single - p_shard) >= 0.2:
        raise AssertionError(f"sharded encode diverged: {p_single} vs {p_shard} dB")

    # 2. The sharded decode on the same mesh equals the per-image decoder.
    decoded = sharded_qmf_decode_batch(streams, mesh)
    if decoded.shape != batch.shape or decoded.dtype != batch.dtype:
        raise AssertionError(f"sharded decode gave {decoded.shape} {decoded.dtype}")
    for i in (0, len(streams) - 1):
        if not np.array_equal(decoded[i], qmf_decode(streams[i], device=first)):
            raise AssertionError(f"sharded decode mismatch on image {i}")

    # 3. Data-only mesh: the BCD kernel against the plain sweeps.
    mesh_dp = make_mesh(data=n_devices, patch=1, devices=devices)
    batch_dp = structured_images(n_devices, 64, 96, rng)
    streams_k = sharded_qmf_encode_batch(batch_dp, mesh_dp, quality=20, num_iters=2, backend="kernel")
    streams_t = sharded_qmf_encode_batch(batch_dp, mesh_dp, quality=20, num_iters=2, backend="torch")
    for i in (0, n_devices - 1):
        p_k, p_t = psnr_of(batch_dp[i], streams_k[i], first), psnr_of(batch_dp[i], streams_t[i], first)
        if abs(p_k - p_t) >= 0.2:
            raise AssertionError(f"kernel / plain BCD divergence on image {i}: {p_k} vs {p_t} dB")
