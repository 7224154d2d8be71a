"""Digests of the port's CPU streams and pixels, to compare two trees.

    python tests/torch_tree_digest.py [TREE]

Imports `lrf_tpu_torch` from TREE (default: this checkout) and prints one
JSON object: a sha256 per call over the per-image `qmf_encode` streams, the
batched encode on one device, on a data mesh of `["cpu"] * 8` and on the
patch meshes 4 x 2 and 1 x 8, the `*_batches` pipeline on a data mesh and,
over 128x128 crops, on one device, and the pixels of
each decode; then over odd-size crops (61x93, whose chroma does not halve
evenly): the `qmf_encode` streams in YCbCr and in RGB, the `svd_encode`
streams in both color spaces, and the `hosvd_encode` and
`patch_hosvd_encode` dicts. Two trees that give the same object encode and
decode the same bytes on this host.
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


def _leaves(tree):
    """The arrays and numbers of a codec's dict, in order, as bytes."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    elif hasattr(tree, "tobytes") or hasattr(tree, "numpy"):
        yield (tree.numpy() if hasattr(tree, "numpy") else tree).tobytes()
    else:
        yield repr(tree).encode()


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
    tall = photos(6, 128, 128, seed=5)  # tall stacks: the exact shared init, one batch run ahead
    out["batches cpu 128x128"] = _sha(s for part in lt.sharded_qmf_encode_batches(
        [tall[:2], tall[2:4], tall[4:]], device="cpu", **kw) for s in part)
    odd = photos(4, 61, 93, seed=11)
    for cs in ("YCbCr", "RGB"):
        out[f"qmf_encode 61x93 {cs}"] = _sha(lt.qmf_encode(img, device="cpu", color_space=cs, **kw) for img in odd)
        out[f"svd_encode 61x93 {cs}"] = _sha(lt.svd_encode(img, quality=20, color_space=cs, device="cpu")
                                             for img in odd)
    out["hosvd_encode 61x93"] = _sha(b for img in odd for b in _leaves(lt.hosvd_encode(img, com_ratio=20, device="cpu")))
    out["patch_hosvd_encode 61x93"] = _sha(b for img in odd for b in _leaves(
        lt.patch_hosvd_encode(img, rank=(3, 4, 4, 2), device="cpu")))
    return out


if __name__ == "__main__":
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.path.dirname(HERE)
    sys.path[:0] = [tree, HERE]
    print(json.dumps(digests(), indent=1, sort_keys=True))
