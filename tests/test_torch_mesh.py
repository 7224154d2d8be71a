"""The port's device meshes against one device and the JAX package's meshes.

- `make_mesh` shapes and errors; `Mesh.split_batch` / `Mesh.replicate`.
- A data mesh of 8 (`["cpu"] * 8`) gives the one device's streams byte for
  byte, for every transport and both inits, and the one device's pixels
  on decode.
- Patch-sharded meshes (4 x 2 and 1 x 8): per-image PSNR within 0.2 dB of
  per-image `qmf_encode`, and of the JAX package's `make_mesh(data=4,
  patch=2)` streams on its 8 virtual CPU devices; deterministic.
- The fused kernel is refused under patch sharding.
- A data mesh dispatches each row from its own host thread, in row order;
  the patch mesh's streams stay what they were before the cross-shard
  copies became non-blocking (sha256 digests, re-recorded when the init
  moved to its float64 Gram and the host's LAPACK eigh).

    python -m pytest --noconftest -m cuda tests/test_torch_mesh.py
"""

import hashlib
import threading

import numpy as np
import pytest
import torch

import lrf_tpu_torch as lt
from lrf_tpu_torch.parallel import decode as tdec
from lrf_tpu_torch.parallel import encode as tenc
from lrf_tpu_torch.parallel.mesh import Mesh, as_mesh
from torch_images import photos

KW = dict(quality=20, num_iters=3)


@pytest.fixture(scope="module")
def batch():
    return photos(8, 48, 64, seed=4)


def _psnr(ref, dec):
    return float(lt.psnr(ref, dec))


def test_make_mesh_shapes_and_errors():
    mesh = lt.make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"data": 8, "patch": 1} and mesh.size == 8 and mesh.first == torch.device("cpu")
    assert lt.make_mesh(patch=2, devices=["cpu"] * 8).shape == {"data": 4, "patch": 2}
    assert lt.make_mesh(data=1, patch=8, devices=["cpu"] * 8).shape == {"data": 1, "patch": 8}
    assert as_mesh("cpu").shape == {"data": 1, "patch": 1} and as_mesh(mesh) is mesh
    for data, patch, n in ((3, 1, 8), (2, 2, 2), (0, 1, 0), (None, 3, 8)):
        with pytest.raises(ValueError, match="does not fit"):
            lt.make_mesh(data=data, patch=patch, devices=["cpu"] * n)
    with pytest.raises(ValueError, match="rectangular"):
        Mesh([["cpu", "cpu"], ["cpu"]])
    with pytest.raises(ValueError, match="unsupported"):
        lt.make_mesh(devices=["meta"])
    x = torch.arange(8 * 3).reshape(8, 3)
    parts = lt.make_mesh(data=4, patch=2, devices=["cpu"] * 8).split_batch(x)
    assert [p.tolist() for p in parts] == [x[2 * i : 2 * i + 2].tolist() for i in range(4)]
    with pytest.raises(ValueError, match="evenly"):
        mesh.split_batch(x[:6])
    assert len(mesh.replicate(x)) == 8 and len(lt.make_mesh(data=4, patch=2, devices=["cpu"] * 8).replicate(x, 1)) == 2


@pytest.mark.parametrize("pack", [None, "flat", "entropy"])
@pytest.mark.parametrize("init", ["svd", "fast"])
def test_data_mesh_equals_one_device(batch, pack, init):
    mesh = lt.make_mesh(devices=["cpu"] * 8)
    want = lt.sharded_qmf_encode_batch(batch, device="cpu", pack=pack, init=init, **KW)
    assert lt.sharded_qmf_encode_batch(batch, device=mesh, pack=pack, init=init, **KW) == want
    if pack is None and init == "svd":
        assert want == [lt.qmf_encode(img, device="cpu", **KW) for img in batch]
        dec = lt.sharded_qmf_decode_batch(want, device=mesh)
        np.testing.assert_array_equal(dec, lt.sharded_qmf_decode_batch(want, device="cpu"))
        on_device = lt.sharded_qmf_decode_batch(want, device=mesh, out="device")
        assert torch.equal(on_device, torch.from_numpy(dec))
        halves = [batch[:4], batch[4:]]
        got = list(lt.sharded_qmf_encode_batches(halves, device=lt.make_mesh(devices=["cpu"] * 4), **KW))
        assert got == [want[:4], want[4:]]
        outs = list(lt.sharded_qmf_decode_batches(got, device=lt.make_mesh(data=2, patch=2, devices=["cpu"] * 4)))
        np.testing.assert_array_equal(np.concatenate(outs), dec)


def test_data_mesh_rows_run_on_their_own_threads(batch, monkeypatch):
    seen = {"encode": [], "decode": []}

    def spy(stage, fn):
        def wrapped(x, *args, **kwargs):
            seen[stage].append((threading.current_thread(), x.shape[0], x[0].clone()))
            return fn(x, *args, **kwargs)

        return wrapped

    want = lt.sharded_qmf_encode_batch(batch, device="cpu", **KW)
    want_dec = lt.sharded_qmf_decode_batch(want, device="cpu")
    monkeypatch.setattr(tenc, "rgb_to_ycbcr", spy("encode", tenc.rgb_to_ycbcr))
    monkeypatch.setattr(tdec, "_reconstruct", spy("decode", tdec._reconstruct))
    mesh = lt.make_mesh(devices=["cpu"] * 4)
    assert lt.sharded_qmf_encode_batch(batch, device=mesh, **KW) == want  # row order kept
    np.testing.assert_array_equal(lt.sharded_qmf_decode_batch(want, device=mesh), want_dec)
    for stage in ("encode", "decode"):
        calls = seen[stage]
        threads = [t for t, _, _ in calls]
        assert len(seen[stage]) == 4 and len(set(threads)) == 4, stage
        assert threading.main_thread() not in threads, stage
        for thread, b, first in calls:  # each thread ran the row its name gives
            row = int(thread.name.rsplit(" ", 1)[1])
            assert b == 2, stage
            if stage == "encode":
                assert torch.equal(first, torch.from_numpy(batch[2 * row]).to(torch.float32))
    # a one-row mesh stays on the calling thread
    seen["encode"].clear()
    lt.sharded_qmf_encode_batch(batch, device="cpu", **KW)
    assert [t for t, _, _ in seen["encode"]] == [threading.current_thread()]


def test_map_rows_keeps_order_counts_and_raises():
    # more row threads than cores, with a short switch interval: the row
    # order holds, the launch counter loses no update, a row's error reaches
    # the caller after every row has ended
    import sys

    from lrf_tpu_torch.ops.bcd_kernel import _KernelLib

    mesh = lt.make_mesh(devices=["cpu"] * 16)
    counter = _KernelLib()
    ended = []

    def row(part, devices):
        for _ in range(2000):
            counter._count("bcd")
        ended.append(int(part[0]))
        return int(part[0])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = mesh.map_rows(row, mesh.split_batch(torch.arange(32)))
        assert got == list(range(0, 32, 2))
        assert counter.counts == {"bcd_cluster": 0, "bcd_cluster_wide": 0, "bcd_grid": 0, "bcd": 16 * 2000}

        def failing(part, devices):
            if int(part[0]) == 6:
                raise ValueError("row 3 failed")
            return row(part, devices)

        ended.clear()
        with pytest.raises(ValueError, match="row 3 failed"):
            mesh.map_rows(failing, mesh.split_batch(torch.arange(32)))
        assert sorted(ended) == [i for i in range(0, 32, 2) if i != 6]
    finally:
        sys.setswitchinterval(old)


# sha256 over the patch-sharded streams of `batch` at KW, recorded before
# the cross-shard copies became non-blocking: the sum order is fixed, so on
# the CPU the bytes must not move. Re-recorded when the color transform took
# the JAX package's FMA order and the exact init its float64 Gram and host
# LAPACK eigh; since then both meshes give the same streams.
PATCH_MESH_DIGESTS = {
    (4, 2): "9327ea47ba1db3dbc96106ec2aa37599e3458b5f88c730238b0cd67f97332641",
    (1, 8): "9327ea47ba1db3dbc96106ec2aa37599e3458b5f88c730238b0cd67f97332641",
}


@pytest.mark.parametrize("data,patch", sorted(PATCH_MESH_DIGESTS))
def test_patch_mesh_bytes_unchanged(batch, data, patch):
    streams = lt.sharded_qmf_encode_batch(batch, device=lt.make_mesh(data=data, patch=patch, devices=["cpu"] * 8), **KW)
    h = hashlib.sha256()
    for s in streams:
        h.update(s)
    assert h.hexdigest() == PATCH_MESH_DIGESTS[(data, patch)]


@pytest.fixture(scope="module")
def jax_patch_streams(batch):
    import jax

    from lrf_tpu.parallel.encode import sharded_qmf_encode_batch
    from lrf_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) == 8
    return sharded_qmf_encode_batch(batch, make_mesh(data=4, patch=2), **KW)


@pytest.mark.parametrize("data,patch", [(4, 2), (1, 8)])
def test_patch_sharded_psnr(batch, jax_patch_streams, data, patch):
    import lrf_tpu

    mesh = lt.make_mesh(data=data, patch=patch, devices=["cpu"] * 8)
    streams = lt.sharded_qmf_encode_batch(batch, device=mesh, **KW)
    assert streams == lt.sharded_qmf_encode_batch(batch, device=mesh, **KW)  # deterministic
    dec = lt.sharded_qmf_decode_batch(streams, device=mesh)
    for i, img in enumerate(batch):
        p_shard = _psnr(img, dec[i])
        p_single = _psnr(img, lt.qmf_decode(lt.qmf_encode(img, device="cpu", **KW), device="cpu"))
        p_jax = _psnr(img, np.asarray(lrf_tpu.qmf_decode(jax_patch_streams[i])))
        assert abs(p_shard - p_single) < 0.2 and abs(p_shard - p_jax) < 0.2, (i, p_shard, p_single, p_jax)
        np.testing.assert_array_equal(dec[i], np.asarray(lrf_tpu.qmf_decode(streams[i])))


def test_patch_sharded_fast_init_and_packs(batch):
    mesh = lt.make_mesh(data=2, patch=4, devices=["cpu"] * 8)
    raw = lt.sharded_qmf_encode_batch(batch, device=mesh, init="fast", **KW)
    assert lt.sharded_qmf_encode_batch(batch, device=mesh, init="fast", pack="entropy", **KW) == raw
    single = lt.sharded_qmf_encode_batch(batch, device="cpu", init="fast", **KW)
    for i, img in enumerate(batch):
        p_shard = _psnr(img, lt.qmf_decode(raw[i], device="cpu"))
        assert abs(p_shard - _psnr(img, lt.qmf_decode(single[i], device="cpu"))) < 0.2, i


def test_kernel_refused_under_patch_sharding(batch):
    patch_mesh = lt.make_mesh(data=4, patch=2, devices=["cpu"] * 8)
    with pytest.raises(NotImplementedError, match="patch"):
        lt.build_sharded_encoder(patch_mesh, (48, 64), backend="kernel", **KW)
    with pytest.raises(ValueError, match="backend"):
        lt.build_sharded_encoder("cpu", (48, 64), backend="pallas", **KW)
    # on a data mesh the kernel's wrapper runs (its plain version on CPU tensors)
    data_mesh = lt.make_mesh(devices=["cpu"] * 8)
    assert lt.sharded_qmf_encode_batch(batch, device=data_mesh, backend="kernel", **KW) == lt.sharded_qmf_encode_batch(
        batch, device="cpu", **KW
    )
    with pytest.raises(ValueError, match="evenly"):
        lt.sharded_qmf_encode_batch(batch[:6], device=data_mesh, **KW)


@pytest.mark.cuda
def test_meshes_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the BCD kernel has no CPU mode)")
    from lrf_tpu_torch.ops import bcd_kernel

    images = photos(4, 96, 128, seed=6)
    want = lt.sharded_qmf_encode_batch(images, quality=10)
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    data_mesh = lt.make_mesh(data=2, devices=(cards * 2)[:2])
    before = bcd_kernel.KERNEL.counts["bcd_cluster"]
    got = lt.sharded_qmf_encode_batch(images, quality=10, device=data_mesh)
    assert bcd_kernel.KERNEL.counts["bcd_cluster"] == before + 4  # Y and Cb+Cr per row
    assert sum(a == b for a, b in zip(got, want)) >= len(images) - 1
    patch_mesh = lt.make_mesh(data=1, patch=2, devices=(cards * 2)[:2])
    before = bcd_kernel.KERNEL.launches
    sharded = lt.sharded_qmf_encode_batch(images, quality=10, device=patch_mesh)
    assert bcd_kernel.KERNEL.launches == before  # the plain sweeps
    for i, img in enumerate(images):
        p_shard = _psnr(img, lt.qmf_decode(sharded[i], device="cpu"))
        assert abs(p_shard - _psnr(img, lt.qmf_decode(want[i], device="cpu"))) < 0.2, i
