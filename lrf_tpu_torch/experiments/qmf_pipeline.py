"""Step-by-step QMF walkthrough of one image.

Port of `experiments/examples/qmf_pipeline.py` (the script form of the
reference's `qmf_pipeline.ipynb`). `stages` computes every stage of the
codec on `device` with the port's own functions and times each:

1. the color transform and the chroma downsample (`rgb_to_ycbcr`,
   `chroma_downsample`);
2. `qmf_encode`, its metadata (`separate_bytes`, `bytes_to_dict`) and bpp;
3. the Y channel's integer factors (`decode_tensor`) as spatial factor
   maps (`depatchify_uv`);
4. the energy fractions of the first four rank-1 terms of Y;
5. `qmf_decode`, PSNR and SSIM.

`draw` saves the JAX script's five figures (`y`, `cb`, `u_maps`, `v_maps`,
`recon`, PNG) with matplotlib; `main` prints what the JAX script prints,
then the stage times, and draws only where matplotlib is installed.

    python -m lrf_tpu_torch.experiments pipeline [--image experiments/data/demo/kodim01.png] [--quality 7]
        [--save_dir qmf_pipeline_out] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import time

import numpy as np
import torch

from lrf_tpu_torch.models.container import bytes_to_dict, decode_tensor, separate_bytes
from lrf_tpu_torch.models.qmf import qmf_decode, qmf_encode
from lrf_tpu_torch.ops.color import rgb_to_ycbcr
from lrf_tpu_torch.ops.patch import depatchify_uv
from lrf_tpu_torch.ops.resample import chroma_downsample
from lrf_tpu_torch.utils.eval import read_image
from lrf_tpu_torch.utils.metrics import bits_per_pixel, psnr, ssim
from lrf_tpu_torch.utils.transfer import resolve_device, to_host

__all__ = ["FIGURES", "stages", "draw", "add_args", "run", "main"]

DEFAULT_IMAGE = os.path.join("experiments", "data", "demo", "kodim01.png")
FIGURES = ("y", "cb", "u_maps", "v_maps", "recon")


def stages(image: np.ndarray, quality: float = 7, device="cuda") -> dict:
    """Every stage of the codec on one `(3, H, W)` uint8 image, on `device`.

    Returns the host arrays the figures draw (`y`, `cb`: `(1, h, w)` float32;
    `u_map`: `(R, 1, h, w)`, `v_map`: `(R, 1, p, q)`; `decoded`), the stream
    and its `metadata`, `bpp`, the rank-1 `energy` fractions, `psnr`,
    `ssim`, and `seconds` per stage (host clock, the device synchronized
    at each stage's end)."""
    device = resolve_device(device)
    seconds = {}
    clock = [time.perf_counter()]

    def lap(stage: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        clock.append(time.perf_counter())
        seconds[stage] = clock[-1] - clock[-2]

    x = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    y, cb, _ = chroma_downsample(rgb_to_ycbcr(x))
    lap("color")
    encoded = qmf_encode(image, quality=quality, device=device)
    lap("encode")
    header, payload = separate_bytes(encoded, 2)
    metadata = bytes_to_dict(header)
    blobs = separate_bytes(payload, 6)
    u = torch.from_numpy(decode_tensor(blobs[0]).astype(np.float32)).to(device)
    v = torch.from_numpy(decode_tensor(blobs[1]).astype(np.float32)).to(device)
    lap("parse")
    u_map, v_map = depatchify_uv(u, v, tuple(metadata["padded size"][0]), tuple(metadata["patch size"]))
    lap("factor maps")
    k = min(4, u.shape[1])
    terms = torch.einsum("mr,nr->rmn", u[:, :k], v[:, :k]).reshape(k, -1)
    energy = (terms**2).sum(dim=1)
    energy = energy / energy.sum()
    lap("rank-1 terms")
    decoded = qmf_decode(encoded, device=device)
    lap("decode")
    ref, dec = x, torch.from_numpy(decoded).to(device)
    p, s = float(psnr(ref, dec)), float(ssim(ref, dec))
    lap("metrics")
    return {
        "y": to_host(y), "cb": to_host(cb), "u_map": to_host(u_map), "v_map": to_host(v_map), "decoded": decoded,
        "encoded": encoded, "metadata": metadata, "bpp": bits_per_pixel(image.shape[-2:], encoded),
        "energy": to_host(energy), "psnr": p, "ssim": s, "seconds": seconds,
    }


def draw(st: dict, save_dir: str) -> list[str]:
    """The JAX script's five figures of `stages`' output, as PNGs in
    `save_dir`; returns their paths."""
    import matplotlib.pyplot as plt

    from lrf_tpu_torch.utils.viz import minmax_normalize, vis_image, vis_image_batch

    vis_image(st["y"] / 255.0, title="Y", save_dir=save_dir, prefix="y", format="png", cmap="gray")
    vis_image(st["cb"] / 255.0, title="Cb (4:2:0)", save_dir=save_dir, prefix="cb", format="png", cmap="gray")
    vis_image_batch(minmax_normalize(st["u_map"][:, 0]), multi_channels=False, title="U factor maps (components)",
                    save_dir=save_dir, prefix="u_maps", format="png", cmap="gray")
    vis_image_batch(minmax_normalize(st["v_map"][:, 0]), multi_channels=False, title="V factor maps (coefficients)",
                    save_dir=save_dir, prefix="v_maps", format="png", cmap="gray")
    vis_image(st["decoded"], title="reconstruction", save_dir=save_dir, prefix="recon", format="png")
    plt.close("all")
    return [os.path.join(save_dir, f"{name}.png") for name in FIGURES]


def add_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--image", type=str, default=DEFAULT_IMAGE)
    ap.add_argument("--quality", type=float, default=7)
    ap.add_argument("--save_dir", type=str, default="qmf_pipeline_out")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def run(args: argparse.Namespace) -> int:
    image = read_image(args.image)
    st = stages(image, args.quality, args.device)
    print("metadata:", st["metadata"])
    print("stream bytes:", len(st["encoded"]), "bpp: %.3f" % st["bpp"])
    print("first rank-1 term energy fractions:", np.round(st["energy"], 3))
    print("PSNR: %.2f dB" % st["psnr"], " SSIM: %.3f" % st["ssim"])
    print("stage times (ms, on %s): %s" % (args.device, ", ".join(
        f"{name} {1e3 * t:.2f}" for name, t in st["seconds"].items())))
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no figures drawn")
        return 0
    import matplotlib

    matplotlib.use("Agg")
    print("figures:", ", ".join(draw(st, args.save_dir)))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m lrf_tpu_torch.experiments pipeline",
                                 description=__doc__.splitlines()[0])
    add_args(ap)
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
