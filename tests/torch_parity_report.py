"""Measured divergences of the PyTorch port from the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py [--tree TREE] [CASE ...]

CASE is any of codec, bcd, hosvd, svd, pool and color (default: all); `--tree` imports
`lrf_tpu_torch` from another checkout (for example a `git archive` of the
parent commit), so that one script reads both sides of a change.

Prints one JSON line per case, with the same inputs the `test_torch_*.py`
tests use (their tests assert the bounds; this script reports the values):

- codec: for kodim01 crops at q10/q20, pixels of one stream decoded by both
  packages (max |diff| and share of differing values, both directions),
  the PSNR of each package's own encode, and stream sizes (the JAX package
  with its zlib coder); then for each `experiments/data/local7` image (its
  top-left 256x384) at q10, q25 and q40, the PSNR gap (port - JAX) of each
  package's own stream and whether the streams are byte-identical (both
  with their default "best" coder), and a summary line of those 21 points;
- bcd: from one JAX init, the share of factor entries the port's plain BCD
  shares with `lrf_tpu.ops.bcd` and with `bcd_pallas(interpret=True)`, and
  the loss difference;
- hosvd: for each `experiments/data/local7` image (its top-left 512x768),
  the PSNR gap (port - JAX) of `hosvd_encode` at com_ratio 50 and of
  `patch_hosvd_encode` at bpp 0.5, each package decoding its own dict
  (`tests/test_torch_hosvd_parity.py` holds the bounds);
- svd: for each `experiments/data/local7` image (its top-left 256x384), the
  PSNR gap (port - JAX) of `svd_encode` in RGB and YCbCr at q10 and q50,
  each package decoding its own stream, whether the streams are
  byte-identical, and, over every matrix the codec factors (the port's X),
  how many of the well-separated components (|cos| > 0.999 against the JAX
  package's `svd`) take the JAX package's sign through LAPACK's `?gesdd`
  (scipy, the port's codec since it factors on the host) and through
  `torch.linalg.svd`;
- pool: for odd widths (the chroma area pool's non-divisible branch), the
  share of `area_resize`'s entries equal to the JAX package's, pooling a
  (1, 64, W) plane of uniform noise to (32, W // 2) and its transpose;
- color: for each `experiments/data/local7` image, the share of Y, Cb and
  Cr entries of the port's `rgb_to_ycbcr` equal to the JAX package's, and
  of the chain ``fma(c2, m2, fma(c1, m1, c0 * m0))`` per output channel
  (each step rounded to float32 from float64, the offset added last), which
  is how XLA's CPU `dot` computes the JAX package's einsum; then, on the
  Y stacks of `tests/test_torch_fast_init.py::test_randomized_matches_jax`
  at rank 13, the largest relative gap between the port's and the JAX
  package's randomized singular values (the test's bound before Weyl's was
  `rtol=1e-4`) and the largest |s_i² - s_jax,i²| / s_jax,0² (the test's
  bound: 2·M·2⁻²⁴), with X from the port's color transform (the test's
  input) and from the JAX package's; and, on 65,536 seeded float32 values
  spread over 2^-30..2^40, the share of torch's float32 `sqrt`, of the
  init's `ops/svd.py::rounded_sqrt` and of the JAX package's `sqrt` equal
  to numpy's (the correctly rounded root).

Not collected by pytest (the file name does not start with `test_`).
"""

import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = sys.argv[1:]
TREE = ARGS[ARGS.index("--tree") + 1] if "--tree" in ARGS else ROOT
CASES = [a for a in ARGS if a not in ("--tree", TREE)] or ["codec", "bcd", "hosvd", "svd", "pool", "color"]
sys.path[:0] = [os.path.abspath(TREE), ROOT]

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
    set_fiber_coder("best")  # both packages' default coder, so that equal factors give equal bytes
    gaps, same = [], 0
    for path in sorted(glob.glob(os.path.join(ROOT, "experiments/data/local7/*.png"))):
        crop = np.ascontiguousarray(np.asarray(Image.open(path).convert("RGB")).transpose(2, 0, 1)[:, :256, :384])
        for q in (10, 25, 40):
            s_jax = lrf_tpu.qmf_encode(crop, quality=q)
            s_port = lrf_tpu_torch.qmf_encode(crop, quality=q, device="cpu")
            gap = (float(lrf_tpu_torch.psnr(crop, lrf_tpu_torch.qmf_decode(s_port, device="cpu")))
                   - float(lrf_tpu.psnr(crop, lrf_tpu.qmf_decode(s_jax))))
            gaps.append(gap)
            same += s_jax == s_port
            print(json.dumps({"case": "codec", "image": os.path.basename(path), "size": [256, 384], "quality": q,
                              "psnr_gap_port_minus_jax": gap, "bytes_identical": s_jax == s_port}), flush=True)
    print(json.dumps({"case": "codec", "size": [256, 384], "points": len(gaps), "bytes_identical": same,
                      "psnr_gap_min": min(gaps), "psnr_gap_max": max(gaps)}), flush=True)


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


def svd_cases():
    import scipy.linalg

    from lrf_tpu_torch.ops.color import rgb_to_ycbcr
    from lrf_tpu_torch.ops.pad import pad_image
    from lrf_tpu_torch.ops.patch import patchify
    from lrf_tpu_torch.ops.resample import chroma_downsample

    def psnr(a, b):
        mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
        return float(10 * np.log10(255.0**2 / mse))

    solvers = {
        "gesdd": lambda a: scipy.linalg.svd(a, full_matrices=False, lapack_driver="gesdd")[0],
        "torch": lambda a: torch.linalg.svd(torch.from_numpy(a), full_matrices=False)[0].numpy(),
    }
    for path in sorted(glob.glob(os.path.join(ROOT, "experiments/data/local7/*.png"))):
        img = np.ascontiguousarray(np.asarray(Image.open(path).convert("RGB")).transpose(2, 0, 1)[:, :256, :384])
        out = {"case": "svd", "image": os.path.basename(path), "size": list(img.shape)}
        for cs in ("RGB", "YCbCr"):
            for q in (10, 50):
                s_port = lrf_tpu_torch.svd_encode(img, quality=q, color_space=cs, device="cpu")
                s_jax = lrf_tpu.svd_encode(img, quality=q, color_space=cs)
                out[f"{cs}_q{q}_gap_db"] = (psnr(img, lrf_tpu_torch.svd_decode(s_port, device="cpu"))
                                            - psnr(img, lrf_tpu.svd_decode(s_jax)))
                out[f"{cs}_q{q}_identical"] = s_port == s_jax
        x = torch.from_numpy(img).to(torch.float32)
        stacks = [patchify(pad_image(x, (8, 8)), (8, 8)), *x]
        for c in chroma_downsample(rgb_to_ycbcr(x), (0.5, 0.5)):
            stacks += [patchify(pad_image(c, (8, 8)), (8, 8)), c[0]]
        for name, solve in solvers.items():
            well = same = 0
            for xm in stacks:
                a = np.ascontiguousarray(xm.numpy())
                u, u_j = solve(a), np.asarray(jnp.linalg.svd(jnp.asarray(a), full_matrices=False)[0])
                cos = (u * u_j).sum(0) / (np.linalg.norm(u, axis=0) * np.linalg.norm(u_j, axis=0))
                sep = np.abs(cos) > 0.999
                well, same = well + int(sep.sum()), same + int((cos[sep] > 0).sum())
            out[f"jax_signs_{name}"] = [same, well]
        print(json.dumps(out), flush=True)


def pool_cases():
    from lrf_tpu.ops import resample as jresample
    from lrf_tpu_torch.ops import resample

    rng = np.random.default_rng(0)
    for width in (61, 93, 333, 401, 425, 427, 429, 455, 517, 663):
        x = (rng.random((1, 64, width)) * 255).astype(np.float32)
        out = {"case": "pool", "width": width}
        for name, a, size in (("rows", x, (32, width // 2)), ("columns", x.transpose(0, 2, 1), (width // 2, 32))):
            a = np.ascontiguousarray(a)
            got = resample.area_resize(torch.from_numpy(a), size).numpy()
            out[f"equal_share_{name}"] = float((got == np.asarray(jresample.area_resize(jnp.asarray(a), size))).mean())
        print(json.dumps(out), flush=True)


def color_cases():
    from lrf_tpu.ops import color as jcolor
    from lrf_tpu_torch.ops import color

    m = np.asarray(color._RGB_TO_YCBCR, np.float32).astype(np.float64)
    offset = np.asarray(color._YCBCR_OFFSET, np.float32)
    for path in sorted(glob.glob(os.path.join(ROOT, "experiments/data/local7/*.png"))):
        rgb = np.asarray(Image.open(path).convert("RGB")).transpose(2, 0, 1).astype(np.float32)
        want = np.asarray(jcolor.rgb_to_ycbcr(jnp.asarray(rgb)))
        port = color.rgb_to_ycbcr(torch.from_numpy(rgb)).numpy()
        c = rgb.astype(np.float64)
        fma = []
        for i in range(3):
            acc = (c[0] * m[i, 0]).astype(np.float32)
            for j in (1, 2):
                acc = (c[j] * m[i, j] + acc).astype(np.float32)
            fma.append(acc + offset[i])
        fma = np.stack(fma)
        out = {"case": "color", "image": os.path.basename(path), "size": list(rgb.shape)}
        for name, got in (("port", port), ("fma_chain", fma)):
            out[f"{name}_equal_share_ycbcr"] = [float((got[i] == want[i]).mean()) for i in range(3)]
        print(json.dumps(out), flush=True)

    from lrf_tpu.ops import svd as jsvd
    from lrf_tpu_torch.ops import svd as tsvd
    from lrf_tpu_torch.ops.patch import patchify

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_images import photos

    rgb = photos(3, 96, 128, seed=13).astype(np.float32)
    out = {"case": "color", "sketch_rank": 13}
    for name, ycbcr in (("port_x", color.rgb_to_ycbcr(torch.from_numpy(rgb))),
                        ("jax_x", torch.from_numpy(np.asarray(jcolor.rgb_to_ycbcr(jnp.asarray(rgb)))))):
        x = patchify(ycbcr[:, :1], (8, 8)).contiguous()
        s_port = tsvd.truncated_svd(x, 13, method="randomized")[1].numpy()
        s_jax = np.asarray(jsvd.truncated_svd(jnp.asarray(x.numpy()), 13, method="randomized")[1])
        out[f"{name}_max_relative_gap"] = float((np.abs(s_port - s_jax) / np.abs(s_jax)).max())
        s2, sj2 = s_port.astype(np.float64) ** 2, s_jax.astype(np.float64) ** 2
        out[f"{name}_max_square_gap_over_s0_square"] = float((np.abs(s2 - sj2) / sj2[:, :1]).max())
    out["weyl_bound"] = 2 * x.shape[-2] * 2.0**-24
    print(json.dumps(out), flush=True)

    rng = np.random.default_rng(0)
    v = (rng.random(1 << 16) * 2.0 ** rng.integers(-30, 40, 1 << 16)).astype(np.float32)
    want = np.sqrt(v)
    out = {"case": "color", "sqrt_values": len(v)}
    for name, got in (("torch_sqrt", torch.sqrt(torch.from_numpy(v)).numpy()),
                      ("rounded_sqrt", tsvd.rounded_sqrt(torch.from_numpy(v)).numpy()),
                      ("jax_sqrt", np.asarray(jnp.sqrt(jnp.asarray(v))))):
        out[f"{name}_equal_share"] = float((got == want).mean())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    for case in CASES:
        globals()[f"{case}_cases"]()
