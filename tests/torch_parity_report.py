"""Measured divergences of the PyTorch port from the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

Prints one JSON line per case, with the same inputs the `test_torch_*.py`
tests use (their tests assert the bounds; this script reports the values):

- codec: for kodim01 crops at q10/q20, pixels of one stream decoded by both
  packages (max |diff| and share of differing values, both directions),
  the PSNR of each package's own encode, and stream sizes (the JAX package
  with its zlib coder);
- bcd: from one JAX init, the share of factor entries the port's plain BCD
  shares with `lrf_tpu.ops.bcd` and with `bcd_pallas(interpret=True)`, and
  the loss difference;
- hosvd: for each `experiments/data/local7` image (its top-left 512x768),
  the PSNR gap (port - JAX) of `hosvd_encode` at com_ratio 50 and of
  `patch_hosvd_encode` at bpp 0.5, each package decoding its own dict
  (`tests/test_torch_hosvd_parity.py` holds the bounds).

Not collected by pytest (the file name does not start with `test_`).
"""

import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

import lrf_tpu  # noqa: E402
import lrf_tpu_torch  # noqa: E402
from lrf_tpu.models.container import set_fiber_coder  # noqa: E402
from lrf_tpu.ops import bcd as jbcd  # noqa: E402
from lrf_tpu.ops.bcd_pallas import bcd_pallas  # noqa: E402
from lrf_tpu_torch.ops import bcd, bcd_kernel  # noqa: E402


def codec_cases():
    img = np.asarray(Image.open(os.path.join(ROOT, "experiments/data/demo/kodim01.png")).convert("RGB"))
    img = img.transpose(2, 0, 1)
    set_fiber_coder("zlib")
    for h, w in ((128, 192), (61, 93)):
        crop = np.ascontiguousarray(img[:, 100 : 100 + h, 200 : 200 + w])
        for q in (10, 20):
            s_jax = lrf_tpu.qmf_encode(crop, quality=q)
            s_port = lrf_tpu_torch.qmf_encode(crop, quality=q, device="cpu")
            out = {"case": "codec", "size": [h, w], "quality": q}
            for name, stream in (("jax_stream", s_jax), ("port_stream", s_port)):
                a = np.asarray(lrf_tpu.qmf_decode(stream)).astype(np.int16)
                b = lrf_tpu_torch.qmf_decode(stream, device="cpu").astype(np.int16)
                out[name] = {"max_diff": int(np.abs(a - b).max()), "share_diff": float((a != b).mean())}
            out["psnr_jax"] = float(lrf_tpu.psnr(crop, lrf_tpu.qmf_decode(s_jax)))
            out["psnr_port"] = float(lrf_tpu_torch.psnr(crop, lrf_tpu_torch.qmf_decode(s_port, device="cpu")))
            out["bytes_jax"], out["bytes_port"] = len(s_jax), len(s_port)
            out["bytes_identical"] = s_jax == s_port
            print(json.dumps(out))


def bcd_cases():
    rng = np.random.default_rng(17)
    for b, m, n, r in ((3, 300, 64, 7), (2, 257, 64, 5), (1, 64, 64, 1), (2, 128, 64, 26)):
        x = rng.integers(0, 256, (b, m, n)).astype(np.float32)
        u0, v0, _ = jbcd.svd_init(jnp.asarray(x), r, bounds=(-16, 15))
        w = jnp.concatenate([jnp.zeros((b, 1, 1)), jnp.ones((b, 1, 1))], axis=-2)
        uj, vj = u0, v0
        for _ in range(4):
            uj, vj, w = jbcd.bcd_sweep(jnp.asarray(x), uj, vj, w, factor=(0, 1), project=jbcd.make_project((-16, 15)))
        up, vp = bcd_pallas(jnp.asarray(x), u0, v0, num_iters=4, bounds=(-16, 15), interpret=True)
        ut, vt = bcd_kernel.bcd(
            torch.from_numpy(x), torch.from_numpy(np.array(u0)), torch.from_numpy(np.array(v0)), num_iters=4
        )
        out = {"case": "bcd", "shape": [b, m, n, r], "iters": 4}
        loss_t = float(bcd.qmf_loss(torch.from_numpy(x), ut, vt).mean())
        for name, (u, v) in (("vs_jax", (uj, vj)), ("vs_pallas", (up, vp))):
            u, v = np.asarray(u), np.asarray(v)
            loss = float(bcd.qmf_loss(torch.from_numpy(x), torch.from_numpy(np.array(u)), torch.from_numpy(np.array(v))).mean())
            out[name] = {
                "u_equal": float((ut.numpy() == u).mean()),
                "v_equal": float((vt.numpy() == v).mean()),
                "loss_diff": loss_t - loss,
            }
        print(json.dumps(out))


def hosvd_cases():
    def psnr(a, b):
        mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
        return float(10 * np.log10(255.0**2 / mse))

    for path in sorted(glob.glob(os.path.join(ROOT, "experiments/data/local7/*.png"))):
        img = np.ascontiguousarray(np.asarray(Image.open(path).convert("RGB")).transpose(2, 0, 1)[:, :512, :768])
        out = {"case": "hosvd", "image": os.path.basename(path), "size": list(img.shape)}
        for codec, enc, dec, kw in (("hosvd", "hosvd_encode", "hosvd_decode", dict(com_ratio=50)),
                                    ("patch_hosvd", "patch_hosvd_encode", "patch_hosvd_decode", dict(bpp=0.5))):
            x_port = getattr(lrf_tpu_torch, dec)(getattr(lrf_tpu_torch, enc)(img, device="cpu", **kw), device="cpu")
            x_jax = getattr(lrf_tpu, dec)(getattr(lrf_tpu, enc)(img, **kw))
            out[f"{codec}_gap_db"] = psnr(img, x_port) - psnr(img, x_jax)
        print(json.dumps(out))


if __name__ == "__main__":
    codec_cases()
    bcd_cases()
    hosvd_cases()
