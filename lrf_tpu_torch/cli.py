"""Command-line interface: encode / decode / info / eval.

Port of `lrf_tpu/cli.py`, with the same commands, flags and codec
detection; JAX's `--platform` becomes `--device {cuda,cpu}` (default
`cuda`, which fails, naming CUDA, where there is none):

    python -m lrf_tpu_torch encode kodim01.png kodim01.lrf --quality 7
    python -m lrf_tpu_torch decode kodim01.lrf roundtrip.png
    python -m lrf_tpu_torch info   kodim01.lrf
    python -m lrf_tpu_torch --device cpu eval kodim01.png --codec qmf --quality 7

`decode` and `info` tell the codec from the stream's JSON metadata: QMF
streams carry a `"bounds"` key, SVD streams a `"quantization"` dict.
Streams are the JAX package's format, so a file written here decodes under
`python -m lrf_tpu decode` and the other way round.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

__all__ = ["main"]


def _detect_codec(stream: bytes) -> tuple[str, dict]:
    from lrf_tpu_torch.models.container import bytes_to_dict, separate_bytes

    metadata = bytes_to_dict(separate_bytes(stream, 2)[0])
    if "bounds" in metadata:
        return "qmf", metadata
    if "quantization" in metadata:
        return "svd", metadata
    raise ValueError("unrecognized stream: metadata matches no known codec")


def _codec(name: str):
    """`(encode, decode)` of a codec by name."""
    from lrf_tpu_torch.models.qmf import qmf_decode, qmf_encode
    from lrf_tpu_torch.models.svd import svd_decode, svd_encode

    return {"qmf": (qmf_encode, qmf_decode), "svd": (svd_encode, svd_decode)}[name]


def _encoder_kwargs(args: argparse.Namespace) -> dict:
    kwargs: dict = {}
    if args.rank is not None:
        kwargs["rank"] = args.rank
    else:
        kwargs["quality"] = args.quality if args.quality is not None else 7.0
    if args.color_space is not None:
        kwargs["color_space"] = args.color_space
    kwargs["patch"] = not args.no_patch
    kwargs["patch_size"] = (args.patch_size, args.patch_size)
    if args.codec == "qmf":
        kwargs["num_iters"] = args.num_iters
        kwargs["bounds"] = tuple(args.bounds)
    return kwargs


def _save_image(path: str, image: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(image).transpose(1, 2, 0)).save(path)


def _set_coder(args: argparse.Namespace) -> None:
    if args.coder:
        from lrf_tpu_torch.models.container import set_fiber_coder

        set_fiber_coder(args.coder)


def _cmd_encode(args: argparse.Namespace) -> int:
    from lrf_tpu_torch.utils.eval import read_image

    _set_coder(args)
    image = read_image(args.input)
    stream = _codec(args.codec)[0](image, device=args.device, **_encoder_kwargs(args))
    with open(args.output, "wb") as f:
        f.write(stream)
    bpp = 8 * len(stream) / (image.shape[-2] * image.shape[-1])
    print(f"{args.output}: {len(stream)} bytes, {bpp:.3f} bpp (CR {image.nbytes / len(stream):.1f})")
    return 0


def _cmd_decode(args: argparse.Namespace) -> int:
    with open(args.input, "rb") as f:
        stream = f.read()
    codec, _ = _detect_codec(stream)
    image = np.asarray(_codec(codec)[1](stream, device=args.device))
    _save_image(args.output, image)
    print(f"{args.output}: {codec} stream -> {image.shape[-2]}x{image.shape[-1]}")
    return 0


def _cmd_info(args: argparse.Namespace) -> int:
    with open(args.input, "rb") as f:
        stream = f.read()
    codec, metadata = _detect_codec(stream)
    # "original size" is per channel ([[H, W], ...], Y first) under YCbCr, a
    # flat [H, W] in the RGB patch path, and absent in the no-patch paths,
    # where the pixel count needs a decode.
    size = metadata.get("original size")
    info = {"codec": codec, "bytes": len(stream)}
    if size is not None:
        h, w = size[0] if isinstance(size[0], (list, tuple)) else size
        info["bit rate (bpp)"] = round(8 * len(stream) / (h * w), 4)
    print(json.dumps({**info, **metadata}, indent=2))
    return 0


def _cmd_eval(args: argparse.Namespace) -> int:
    from lrf_tpu_torch.utils.eval import eval_compression

    _set_coder(args)
    encode, decode = _codec(args.codec)
    result = eval_compression(args.input, encode, decode, device=args.device, **_encoder_kwargs(args))
    print(json.dumps(result, indent=2))
    return 0


def _add_encoder_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--codec", choices=("qmf", "svd"), default="qmf")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--quality", type=float, help="quality in [0, 100] (default 7)")
    g.add_argument("--rank", type=int, help="explicit factorization rank")
    p.add_argument("--color-space", choices=("YCbCr", "RGB"),
                   help="default: YCbCr for qmf, RGB for svd (reference defaults)")
    p.add_argument("--patch-size", type=int, default=8)
    p.add_argument("--no-patch", action="store_true", help="factorize whole channels")
    p.add_argument("--num-iters", type=int, default=10, help="BCD sweeps (qmf)")
    p.add_argument("--bounds", type=int, nargs=2, default=(-16, 15), help="integer factor bounds (qmf)")
    p.add_argument(
        "--coder",
        choices=("best", "zlib", "deflate"),
        help="fiber coder backend; 'best' (default) emits the smaller of zlib-9/libdeflate-12 per fiber, "
        "'deflate' is the fast throughput choice, 'zlib' is byte-identical to the reference; all emit "
        "reference-decodable zlib streams",
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="lrf_tpu_torch", description="low-rank-factorization image codec on PyTorch")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where encode, decode and eval compute (default cuda)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("encode", help="compress an image file to an .lrf stream")
    p.add_argument("input", help="image file (anything PIL reads)")
    p.add_argument("output", help="output stream path")
    _add_encoder_flags(p)
    p.set_defaults(func=_cmd_encode)

    p = sub.add_parser("decode", help="decompress an .lrf stream to an image file")
    p.add_argument("input", help=".lrf stream path")
    p.add_argument("output", help="output image path (format from extension)")
    p.set_defaults(func=_cmd_decode)

    p = sub.add_parser("info", help="print a stream's codec + metadata as JSON")
    p.add_argument("input", help=".lrf stream path")
    p.set_defaults(func=_cmd_info)

    p = sub.add_parser("eval", help="encode+decode an image, print quality metrics")
    p.add_argument("input", help="image file")
    _add_encoder_flags(p)
    p.set_defaults(func=_cmd_eval)

    args = parser.parse_args(argv)
    if args.func is not _cmd_info:
        from lrf_tpu_torch.utils.transfer import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as err:
            print(f"lrf_tpu_torch: {err}", file=sys.stderr)
            return 2
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
