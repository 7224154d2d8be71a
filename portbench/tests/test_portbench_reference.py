"""The plain reference against the program on the CPU, its control, and
the faults that a run's comparison must catch."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import images
from portbench.calibrate import readings
from portbench.reference import codec, compare
from portbench.tests.test_portbench_harness import TINY, dry_run, tiny

SEED = 2**33 + 21


@pytest.fixture(scope="module")
def batch():
    cell = tiny("kodak-q10.encode")
    cfg = cell.config
    pool = images.make_pool(cfg["images"], tuple(cfg["image_size"]), 3, 1, SEED, "cpu")
    return cfg, pool[0]


def test_reference_reads_and_decodes_the_programs_stream(batch):
    import lrf_tpu_torch as lt

    cfg, imgs = batch
    streams = lt.sharded_qmf_encode_batch(imgs, device="cpu", quality=cfg["quality"])
    got, bad = compare.parse_batch(streams, cfg, imgs.shape[-2:])
    assert bad == 0
    md = codec.metadata(imgs.shape[-2:], cfg["quality"])
    np.testing.assert_array_equal(codec.decode(md, got, "cpu"), lt.sharded_qmf_decode_batch(streams, device="cpu"))
    # on the CPU the program's arithmetic is the reference's: every factor entry agrees
    assert compare.apart_per_image(got, compare.reference_factors(imgs, cfg, "cpu")).max() == 0


def test_a_damaged_stream_is_unreadable(batch):
    import lrf_tpu_torch as lt

    cfg, imgs = batch
    streams = lt.sharded_qmf_encode_batch(imgs, device="cpu", quality=cfg["quality"])
    cut = streams[0][: len(streams[0]) // 2]
    flipped = bytearray(streams[1])
    flipped[len(flipped) - 20] ^= 0xFF
    assert compare.parse_batch([cut, bytes(flipped)] + streams[2:], cfg, imgs.shape[-2:]) == (None, 2)


@pytest.mark.parametrize("name", ["kodak-q10.encode", "kodak-q10.decode"])
def test_control_fails_the_limits(name):
    """The reference one precision lower (bfloat16) in the program's place
    reads past a limit; the program itself does not."""
    cell = tiny(name)
    sound = readings(cell, SEED, ["cpu"], control=False)
    low = readings(cell, SEED, ["cpu"], control=True)
    assert all(v <= cell.limits[k] for k, v in sound.items())
    assert any(v > cell.limits[k] for k, v in low.items())


def _stuck_bcd(x, u0, v0, num_iters=10, bounds=(-16, 15)):
    return u0.float(), v0.float()


def _half_serialize(serialize):
    def run(host_out, pack_spec, metadata, b):
        half = [np.concatenate([f[: b // 2], f[: b - b // 2]]) for f in host_out]
        return serialize(half, pack_spec, metadata, b)
    return run


def _altered_serialize(serialize):
    def run(host_out, pack_spec, metadata, b):
        host_out = [f.copy() for f in host_out]
        host_out[0][0] = np.clip(host_out[0][0] + 3, -16, 15)
        return serialize(host_out, pack_spec, metadata, b)
    return run


def _later_altered(fn, first_calls):
    """`fn` with every answer after its first `first_calls` altered: the
    untimed batches' and each pool batch's first answer stay sound."""
    calls = []

    def run(*args):
        calls.append(1)
        n = len(calls)
        out = fn(*args)
        if n <= first_calls:
            return out
        if isinstance(out, list):
            return [out[0][:-1] + bytes([out[0][-1] ^ 1])] + out[1:]
        out = out.copy()
        out[0, 0, 0, 0] ^= 1
        return out
    return run


def _half_decode(decode):
    def run(*args):
        out = decode(*args)
        out[len(out) - len(out) // 2:] = out[: len(out) // 2]
        return out
    return run


def _altered_decode(decode):
    def run(*args):
        out = decode(*args).copy()
        out[0, :, :16, :16] ^= 0x10
        return out
    return run


def _first_row_only(map_rows):
    def run(self, fn, parts):
        out = map_rows(self, fn, parts)
        return [out[0]] * len(out)
    return run


@pytest.mark.parametrize("name,fault", [
    ("kodak-q10.encode", "state unchanged"),
    ("kodak-q10.encode", "half the batch"),
    ("kodak-q10.encode", "answer altered"),
    ("clic-q10.encode-dp4", "exchange between cards"),
    ("kodak-q10.decode", "half the batch"),
    ("kodak-q10.decode", "answer altered"),
    ("kodak-q10.encode", "later answers altered"),
    ("kodak-q10.decode", "later answers altered"),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    from lrf_tpu_torch.parallel import decode as pdec
    from lrf_tpu_torch.parallel import encode as penc
    from lrf_tpu_torch.parallel.mesh import Mesh

    if fault == "state unchanged":
        monkeypatch.setattr(penc, "bcd", _stuck_bcd)
    elif fault == "later answers altered":
        # the untimed batches, the decode cell's set-up encode of the pool, then one first answer a pool batch
        cell = tiny(name)
        firsts = cell.mix["warmup_batches"] + cell.mix["pool"]
        if name.endswith("decode"):
            monkeypatch.setattr(pdec, "_device_decode", _later_altered(pdec._device_decode, firsts))
        else:
            monkeypatch.setattr(penc, "_serialize_batch", _later_altered(penc._serialize_batch, firsts))
    elif fault == "exchange between cards":
        monkeypatch.setattr(Mesh, "map_rows", _first_row_only(Mesh.map_rows))
    elif name.endswith("decode"):
        wrap = _half_decode if fault == "half the batch" else _altered_decode
        monkeypatch.setattr(pdec, "_device_decode", wrap(pdec._device_decode))
    else:
        wrap = _half_serialize if fault == "half the batch" else _altered_serialize
        monkeypatch.setattr(penc, "_serialize_batch", wrap(penc._serialize_batch))
    assert TINY["batch"] >= 2
    result = dry_run(name)
    assert result["correct"] is False
