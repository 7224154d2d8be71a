"""The port's chroma area pool against the JAX package's, on the CPU, and
the card's front end against the CPU's.

Where the size does not divide, `lrf_tpu_torch/ops/resample.py` sums each
window's rounded products ``x[s + k] * w`` in tap order with elementwise
ops, where the JAX package contracts an `(out, in)` weight matrix:

- at widths where XLA's CPU dot also sums in tap order the bits are the
  JAX package's (`WIDTHS`);
- an image pooled alone equals the same image pooled in a batch of 4, at
  those widths and at 425-429, where XLA sums in another order;
- the pool makes no matmul;
- the divisible branch is the reshape-mean it was;
- on the card (`cuda`), the front end (color, pool, pad, patchify) of two
  odd-size photographs equals the CPU's bit for bit.

About 8 s on one core of this host, most of it importing JAX. JAX is
imported inside the CPU tests, so that the `cuda` case runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_frontend_parity.py
"""

import os

import numpy as np
import pytest
import torch

from lrf_tpu_torch.ops import color, pad, patch, resample

import torch_images

WIDTHS = (333, 401, 455, 517, 663)
OTHER_ORDER = (425, 427, 429)  # odd widths where XLA's dot takes another order
ROWS = 16


def _jax_area_resize(x: np.ndarray, size) -> np.ndarray:
    import jax.numpy as jnp

    from lrf_tpu.ops import resample as jresample

    return np.asarray(jresample.area_resize(jnp.asarray(x), size))


def _plane(rows: int, width: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + width)
    return (rng.random((1, rows, width)) * 255).astype(np.float32)


@pytest.mark.parametrize("width", WIDTHS)
def test_area_resize_equals_jax_bits(width):
    x = _plane(ROWS, width)
    size = (ROWS // 2, width // 2)
    want = _jax_area_resize(x, size)
    got = resample.area_resize(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(got, want)
    # along the rows too (a photograph's odd height)
    xt = np.ascontiguousarray(x.transpose(0, 2, 1))
    want = _jax_area_resize(xt, size[::-1])
    np.testing.assert_array_equal(resample.area_resize(torch.from_numpy(xt), size[::-1]).numpy(), want)


@pytest.mark.parametrize("width", WIDTHS + OTHER_ORDER)
def test_pool_does_not_depend_on_the_batch(width):
    batch = np.stack([_plane(ROWS, width, seed=s) for s in range(4)])
    size = (ROWS // 2, width // 2)
    together = resample.area_resize(torch.from_numpy(batch), size)
    for i in range(4):
        alone = resample.area_resize(torch.from_numpy(batch[i]), size)
        assert torch.equal(alone, together[i])


def test_pool_takes_no_matmul(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the area pool ran a matmul")

    for name in ("einsum", "matmul", "bmm"):
        monkeypatch.setattr(torch, name, refuse)
    x = torch.from_numpy(_plane(ROWS + 1, 427))
    for size in ((8, 213), (33, 854)):  # down, and up as the SVD decoder's "area" upsample
        out = resample.area_resize(x, size)
        assert tuple(out.shape) == (1, *size) and bool(torch.isfinite(out).all())
    ycbcr = torch.from_numpy(np.concatenate([_plane(61, 93, seed=s) for s in range(3)]))
    y, cb, cr = resample.chroma_downsample(ycbcr, (0.5, 0.5))
    assert tuple(cb.shape) == tuple(cr.shape) == (1, 30, 46)
    assert tuple(resample.chroma_upsample((y, cb, cr), (61, 93), mode="area").shape) == (3, 61, 93)


def test_divisible_branch_is_the_reshape_mean():
    x = _plane(ROWS, 768)
    got = resample.area_resize(torch.from_numpy(x), (ROWS // 2, 384))
    want = torch.from_numpy(x).reshape(1, ROWS // 2, 2, 384, 2).mean(dim=2).mean(dim=-1)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), _jax_area_resize(x, (ROWS // 2, 384)))


def _front_end(img: np.ndarray, device: str) -> list:
    x = torch.from_numpy(img).to(device)
    return [patch.patchify(pad.pad_image(c, (8, 8)), (8, 8)).cpu()
            for c in resample.chroma_downsample(color.rgb_to_ycbcr(x), (0.5, 0.5))]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["china.png", "clic_flower_fig.png"])
def test_card_front_end_equals_the_cpus(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    img = torch_images.load(os.path.join(torch_images.DATA, "local7", name))
    for card, cpu in zip(_front_end(img, "cuda"), _front_end(img, "cpu")):
        assert card.shape == cpu.shape
        assert int((card != cpu).sum()) == 0
