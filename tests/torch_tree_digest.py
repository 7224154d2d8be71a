"""Digests of the port's CPU streams and pixels, to compare two trees.

    python tests/torch_tree_digest.py [TREE]

Imports `lrf_tpu_torch` from TREE (default: this checkout) and prints one
JSON object: a sha256 per call over the per-image `qmf_encode` streams, the
batched encode on one device, on a data mesh of `["cpu"] * 8` and on the
patch meshes 4 x 2 and 1 x 8, the `*_batches` pipeline, and the pixels of
each decode. Two trees that give the same object encode and decode the same
bytes on this host.
"""

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _sha(chunks) -> str:
    h = hashlib.sha256()
    for c in chunks:
        h.update(c if isinstance(c, bytes) else c.tobytes())
    return h.hexdigest()


def digests() -> dict:
    import lrf_tpu_torch as lt
    from torch_images import photos

    kw = dict(quality=20, num_iters=3)
    batch = photos(8, 48, 64, seed=4)
    out = {}
    single = lt.sharded_qmf_encode_batch(batch, device="cpu", **kw)
    out["qmf_encode"] = _sha(lt.qmf_encode(img, device="cpu", **kw) for img in batch)
    out["batch cpu"] = _sha(single)
    out["decode cpu"] = _sha([lt.sharded_qmf_decode_batch(single, device="cpu")])
    for name, (data, patch) in {"data 8": (8, 1), "patch 4x2": (4, 2), "patch 1x8": (1, 8)}.items():
        mesh = lt.make_mesh(data=data, patch=patch, devices=["cpu"] * 8)
        streams = lt.sharded_qmf_encode_batch(batch, device=mesh, **kw)
        out[f"batch {name}"] = _sha(streams)
        out[f"decode {name}"] = _sha([lt.sharded_qmf_decode_batch(streams, device=mesh)])
    halves = [batch[:4], batch[4:]]
    out["batches data 4"] = _sha(s for part in lt.sharded_qmf_encode_batches(
        halves, device=lt.make_mesh(devices=["cpu"] * 4), **kw) for s in part)
    return out


if __name__ == "__main__":
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.path.dirname(HERE)
    sys.path[:0] = [tree, HERE]
    print(json.dumps(digests(), indent=1, sort_keys=True))
