"""Readings that the limits of `limits/<cell>.json` are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed, at the cell's own sizes, the program answers the pool once
through the cell's pipeline (on its mesh) and the comparison reads its
numbers: the sound runs' readings. For each control seed, the reference
computed one precision lower (bfloat16 for the configuration's float32)
stands in the program's place and the same comparison reads it: the
control, which the limits must fail. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def program_answers(cell, pool, devices):
    """The program's first answer for each pool batch, and the streams the
    decode cells feed (None for encode cells)."""
    from lrf_tpu_torch.parallel.decode import sharded_qmf_decode_batches
    from lrf_tpu_torch.parallel.encode import sharded_qmf_encode_batches
    from lrf_tpu_torch.parallel.mesh import make_mesh

    from portbench.harness import _encoder_args

    rows = int(cell.mix.get("rows", 1))
    mesh = devices[0] if rows == 1 else make_mesh(data=rows, devices=devices[:rows])
    kw = _encoder_args(cell.config)
    streams = list(sharded_qmf_encode_batches(pool, device=mesh, depth=int(cell.mix.get("depth", 3)), **kw))
    if cell.mix["kind"] == "encode":
        return dict(enumerate(streams)), None
    pixels = sharded_qmf_decode_batches(streams, device=mesh, transport=cell.mix.get("transport", "flat"))
    return dict(enumerate(pixels)), streams


def readings(cell, seed: int, devices, control: bool) -> dict:
    from portbench import images
    from portbench.harness import CHECK_CHUNK
    from portbench.reference import codec, compare

    cfg = cell.config
    rows = int(cell.mix.get("rows", 1))
    pool = images.make_pool(cfg["images"], tuple(cfg["image_size"]), int(cfg["batch"]) * rows,
                            int(cell.mix["pool"]), seed, devices[0])
    chunk = CHECK_CHUNK
    if cell.mix["kind"] == "encode":
        if not control:
            return compare.encode_numbers(program_answers(cell, pool, devices)[0], pool, cfg, devices[0], chunk)
        shares = []
        for images_ in pool:
            low = compare.reference_factors(images_, cfg, devices[0], "bfloat16", chunk)
            shares.append(compare.apart_per_image(low, compare.reference_factors(images_, cfg, devices[0], chunk=chunk)))
        shares = np.concatenate(shares)
        return {"unreadable": 0, "apart_mean": float(shares.mean()), "apart_worst": float(shares.max())}
    answers, streams = program_answers(cell, pool, devices)
    if control:
        size = tuple(cfg["image_size"])
        md = codec.metadata(size, cfg["quality"], tuple(cfg["bounds"]), tuple(cfg["scale_factor"]),
                            tuple(cfg["patch_size"]))
        answers = {j: codec.decode(md, compare.parse_batch(s, cfg, size)[0], devices[0], "bfloat16")
                   for j, s in enumerate(streams)}
    return compare.decode_cell_numbers(answers, streams, pool, cfg, devices[0], chunk=chunk)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)

    import torch

    from portbench.cells import resolve

    cell = resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            t0 = time.perf_counter()
            numbers = readings(cell, seed, devices, control)
            print(json.dumps({"workload": cell.name, "seed": seed, "control": control, "numbers": numbers,
                              "seconds": round(time.perf_counter() - t0, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
