"""The port's entropy transport pack against the JAX package's.

Contract: the static code tables are equal; for the same integer factors,
`pack_segments` gives the JAX package's words (`seg_row_base`, `main`,
`exc`) bit for bit, including a pack that overflows its row budget; the
plain decoder and the native one both invert the port's pack.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lrf_tpu.ops import entropy as J
from lrf_tpu_torch.native import fibercodec as tnative
from lrf_tpu_torch.ops import entropy as T

RNG = np.random.default_rng(11)

# (shapes, max_exc_rows): a codec-like set of six factors, a single short
# segment, and one whose budget of 8 rows overflows.
CASES = [
    ([(3, 300, 7), (3, 64, 7), (3, 75, 3), (3, 64, 3), (3, 75, 3), (3, 64, 3)], None),
    ([(1, 64, 1)], None),
    ([(2, 129, 5), (2, 64, 5)], 8),
]


def _factors(shapes, kind):
    """Seeded int8 factors in [-16, 15]: smooth along M (as QMF factors
    are) or uniform."""
    out = []
    for s in shapes:
        if kind == "smooth":
            f = np.cumsum(RNG.integers(-3, 4, s), axis=1)
        else:
            f = RNG.integers(-16, 16, s)
        out.append(np.clip(f, -16, 15).astype(np.int8))
    return out


def _u32(x):
    return np.asarray(x).view(np.uint32) if np.asarray(x).dtype != np.uint32 else np.asarray(x)


def test_tables_equal_jax():
    np.testing.assert_array_equal(T.LENS, J.LENS)
    np.testing.assert_array_equal(T.CODES, J.CODES)
    assert T._LEN_STEPS == J._LEN_STEPS and T._OFF_STEPS == J._OFF_STEPS
    assert (T.CHUNK, T.MAIN_WORDS, T.ROW_WORDS, T.REG_WORDS, T.MAX_ROWS, T.PAD_SYMBOL) == (
        J.CHUNK, J.MAIN_WORDS, J.ROW_WORDS, J.REG_WORDS, J.MAX_ROWS, J.PAD_SYMBOL,
    )
    freqs = RNG.integers(0, 1000, 40).astype(np.float64)
    for got, want in zip(T.canonical_huffman(freqs, max_len=9), J.canonical_huffman(freqs, max_len=9)):
        np.testing.assert_array_equal(got, want)
    assert T.expected_bits_per_value() == J.expected_bits_per_value()
    shapes = CASES[0][0]
    assert T.segment_layout(shapes) == J.segment_layout(shapes)
    assert T.segment_ranks(shapes) == J.segment_ranks(shapes)
    assert [T.default_exc_rows(c) for c in (0, 7, 12345)] == [J.default_exc_rows(c) for c in (0, 7, 12345)]


@pytest.mark.parametrize("kind", ["smooth", "uniform"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_pack_segments_words_equal_jax(case, kind):
    shapes, max_rows = CASES[case]
    factors = _factors(shapes, kind)
    want = J.pack_segments([jnp.asarray(f) for f in factors], max_exc_rows=max_rows)
    got = T.pack_segments([torch.from_numpy(f) for f in factors], max_exc_rows=max_rows)
    assert all(t.dtype == torch.int32 for t in got)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(_u32(got[1].numpy()), _u32(want[1]))
    np.testing.assert_array_equal(_u32(got[2].numpy()), _u32(want[2]))
    budget = max_rows if max_rows is not None else T.default_exc_rows(T.segment_layout(shapes)[2][-1])
    assert got[2].numel() == budget * T.ROW_WORDS
    if max_rows is not None:
        assert int(got[0][-1]) > max_rows  # this case overflows its budget


@pytest.mark.parametrize("kind", ["smooth", "uniform"])
@pytest.mark.parametrize("case", [0, 1])
def test_decoders_invert_the_pack(case, kind):
    shapes, _ = CASES[case]
    factors = _factors(shapes, kind)
    values, _, bounds = T.segment_layout(shapes)
    room = bounds[-1] * T.MAX_ROWS  # every chunk's worst case: never overflows
    seg_base, main, exc = (t.numpy() for t in T.pack_segments([torch.from_numpy(f) for f in factors], room))
    ranks = T.segment_ranks(shapes)
    want = np.concatenate([f.reshape(-1) for f in factors])
    n_rows = int(seg_base[-1])
    exc_used = _u32(exc)[: n_rows * T.ROW_WORDS]
    plain = T.decode_segments_py(_u32(main), exc_used, seg_base, values, ranks)
    np.testing.assert_array_equal(plain, want)
    native = tnative.dpack_decode_segments(
        _u32(main), exc_used, seg_base, values, ranks, T.LENS, T.CODES, T.CHUNK, T.MAIN_WORDS, T.ROW_WORDS
    )
    np.testing.assert_array_equal(native, want)
