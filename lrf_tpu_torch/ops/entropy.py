"""Entropy coding of QMF factors on the device (delta + zigzag static Huffman).

Port of `lrf_tpu/ops/entropy.py:50-347` and `:461-530`, encode direction.
The packed words are identical to the JAX package's for the same factors:

- each `(B, M, R)` int8 factor is differenced along M (first row raw);
  values in [-16, 15] give deltas in [-31, 31], mapped to zigzag symbols
  `zz = 2d (d >= 0) / -2d - 1 (d < 0)`;
- a static canonical Huffman code with lengths monotone in `zz`
  (`_monotone_table` over the histogram `_HIST_ZZ`), so a code's length and
  word are staircase functions of `zz` (`_LEN_STEPS`, `_OFF_STEPS`);
- values are grouped into chunks of CHUNK = 128; every chunk owns a fixed
  MAIN_WORDS = 7 word slot of the main stream, and chunks whose codes run
  past it continue in ROW_WORDS = 1 word rows of the exception stream,
  allocated densely in chunk order;
- a per-segment (factor x image) row-base table lets the host decode the
  segments in parallel (`native/fibercodec.cpp::lrf_dpack_assemble_streams`;
  `decode_segments_py` is the plain version).

`pack_segments` runs as PyTorch ops on the factors' device. `torch.uint32`
has almost no integer ops, so the bit arithmetic runs in int64 and the
words come back as int32 tensors holding the uint32 bit patterns
(`.numpy().view(np.uint32)` on the host).

The decode direction (`lrf_tpu/ops/entropy.py:350-458`): the host encodes
the upload (`native/fibercodec.cpp::lrf_dpack_encode`, the host mirror of
`pack_segments`) and `unpack_chunks_device` undoes it on the device, every
chunk at once, CHUNK sequential steps of elementwise work.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

CHUNK = 128  # values per chunk
MAIN_WORDS = 7  # fixed per-chunk slot in the main stream (224 bits)
ROW_WORDS = 1  # continuation-row granularity (32 bits)

# Zigzag-ordered delta histogram (zz=0 -> delta 0, 1 -> -1, 2 -> +1, ...),
# the JAX package's table, collected over the repo's demo and local7
# images' QMF factors at qualities {5, 10, 25, 40}. The counts only tune
# compression, never correctness.
_HIST_ZZ = np.array(
    [
        1332584, 238036, 239694, 76386, 76689, 29753, 29886, 13663, 13450,
        6431, 6579, 3449, 3744, 1998, 2030, 1158, 1067, 732, 652, 488, 337,
        203, 222, 174, 130, 98, 75, 56, 41, 27, 41, 111, 32, 17, 23, 19, 13,
        17, 19, 8, 6, 11, 3, 4, 2, 1, 0, 5, 2, 1, 9, 2, 5, 0, 6, 0, 5, 0,
        0, 0, 0, 0, 0,
    ],
    dtype=np.float64,
)

MAX_LEN = 12  # code-length cap


def _bit_reverse(code: int, length: int) -> int:
    r = 0
    for _ in range(length):
        r = (r << 1) | (code & 1)
        code >>= 1
    return r


def canonical_huffman(freqs: np.ndarray, max_len: int = MAX_LEN):
    """Static canonical Huffman code: (lens, codes_lsb_first).

    Plain Huffman tree; if a code exceeds `max_len`, the frequency floor is
    raised and the tree rebuilt. Codes are canonical (shortest first,
    symbol-order ties) and bit-reversed, so encoder and decoder read
    LSB-first.
    """
    n = len(freqs)
    f = freqs.astype(np.float64) + 1e-9
    while True:
        heap = [(w, i) for i, w in enumerate(f)]
        heapq.heapify(heap)
        children = {}
        nxt = n
        while len(heap) > 1:
            aw, ai = heapq.heappop(heap)
            bw, bi = heapq.heappop(heap)
            children[nxt] = (ai, bi)
            heapq.heappush(heap, (aw + bw, nxt))
            nxt += 1
        lens = np.zeros(n, dtype=np.int32)
        stack = [(heap[0][1], 0)]
        while stack:
            nid, d = stack.pop()
            if nid < n:
                lens[nid] = max(d, 1)
            else:
                left, right = children[nid]
                stack += [(left, d + 1), (right, d + 1)]
        if lens.max() <= max_len:
            break
        f = np.maximum(f, f.max() / (1 << (max_len - 2)))
    codes = np.zeros(n, dtype=np.uint32)
    code = 0
    prev = 0
    for s in np.lexsort((np.arange(n), lens)):
        length = int(lens[s])
        code <<= length - prev
        codes[s] = code
        code += 1
        prev = length
    rev = np.array([_bit_reverse(int(codes[s]), int(lens[s])) for s in range(n)], dtype=np.uint32)
    return lens.astype(np.int32), rev


def _monotone_table(freqs: np.ndarray):
    """Zigzag-monotone canonical code: the optimal Huffman lengths sorted
    ascending in symbol order. Returns (lens, codes_lsb, len_steps,
    off_steps); the step tables give `len(zz)` and `code_msb(zz) = zz +
    off(zz)` as staircase functions of `zz`."""
    lens_opt, _ = canonical_huffman(freqs)
    lens = np.sort(lens_opt).astype(np.int32)
    codes_msb = np.zeros(len(lens), dtype=np.int64)
    code = 0
    prev = int(lens[0])
    for s in range(len(lens)):
        length = int(lens[s])
        code <<= length - prev
        codes_msb[s] = code
        code += 1
        prev = length
    rev = np.array([_bit_reverse(int(codes_msb[s]), int(lens[s])) for s in range(len(lens))], dtype=np.uint32)
    len_steps, off_steps = [], []
    prev_off = 0
    for s in range(len(lens)):
        if s == 0 or lens[s] != lens[s - 1]:
            off = int(codes_msb[s]) - s
            if s == 0:
                len_steps.append((0, int(lens[0])))
                off_steps.append((0, off))
            else:
                len_steps.append((s, int(lens[s] - lens[s - 1])))
                off_steps.append((s, off - prev_off))
            prev_off = off
    return lens, rev, tuple(len_steps), tuple(off_steps)


LENS, CODES, _LEN_STEPS, _OFF_STEPS = _monotone_table(_HIST_ZZ)

PAD_SYMBOL = 0  # zz=0 (delta 0), the cheapest code, pads segment tails

REG_WORDS = -(-CHUNK * int(LENS.max()) // 32)  # worst-case whole chunk
MAX_ROWS = -(-(REG_WORDS - MAIN_WORDS) // ROW_WORDS)

_U32 = 0xFFFFFFFF


def segment_layout(shapes):
    """Per-(factor, image) segment sizes for a list of (B, M, R) shapes.

    Returns (values_per_segment, chunks_per_segment, segment_chunk_bounds),
    bounds holding n_segments + 1 cumulative chunk indices.
    """
    values, chunks = [], []
    for shape in shapes:
        b = shape[0]
        per = int(np.prod(shape[1:]))
        values += [per] * b
        chunks += [-(-per // CHUNK)] * b
    bounds = [0]
    for c in chunks:
        bounds.append(bounds[-1] + c)
    return values, chunks, bounds


def segment_ranks(shapes):
    """Per-segment trailing-axis stride (R of the (B, M, R) factor), for the
    delta undo."""
    ranks = []
    for shape in shapes:
        ranks += [int(shape[-1])] * shape[0]
    return ranks


def default_exc_rows(c_total: int) -> int:
    """Continuation-row budget for `c_total` chunks: 4.5 rows per chunk plus
    64. The whole budget is fetched every batch; the encoder adapts it to
    observed usage (`parallel/encode._observe_entropy_rows`), and a batch
    that exceeds it is re-encoded with the flat pack."""
    return 4 * c_total + (c_total >> 1) + 64


def _encode_symbols(zz: torch.Tensor):
    """(lens, codes_lsb) of int64 zigzag symbols from the staircase tables,
    as int64 tensors (codes hold 32-bit patterns)."""
    ln = torch.zeros_like(zz)
    off = torch.zeros_like(zz)
    for b, d in _LEN_STEPS:
        ln += (zz >= b).to(torch.int64) * d
    for b, d in _OFF_STEPS:
        off += (zz >= b).to(torch.int64) * d
    # the MSB-first code zz + off, bit-reversed; its low `ln` bits are the
    # LSB-first code
    return ln, _bit_reverse32(zz + off) >> (32 - ln)


def _bit_reverse32(x: torch.Tensor) -> torch.Tensor:
    """Bit reversal of int64 tensors holding 32-bit patterns."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & _U32


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32-bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def pack_segments(factors, max_exc_rows=None):
    """Delta+Huffman pack of a list of (B, M, R) integer factor tensors, on
    their device.

    Returns `(seg_row_base, main, exc)`, int32 tensors (the last two hold
    uint32 bit patterns):
      - `seg_row_base`: (n_segments + 1,) continuation-row rank at each
        segment boundary; the last entry is the total row count. If it
        exceeds `max_exc_rows` (default `default_exc_rows`), `exc` is
        truncated and the caller must fall back to the flat pack;
      - `main`: (C * MAIN_WORDS,) a fixed slot per chunk;
      - `exc`: (max_exc_rows * ROW_WORDS,); rows [0, seg_row_base[-1])
        carry data, the rest are zero.
    """
    device = factors[0].device
    # ---- delta -> zigzag chunk matrix (C, CHUNK), segment-padded
    chunk_rows = []
    for f in factors:
        fi = f.to(torch.int64)
        d = torch.cat([fi[:, :1, :], fi[:, 1:, :] - fi[:, :-1, :]], dim=1)
        zz = torch.where(d >= 0, 2 * d, -2 * d - 1)
        b = f.shape[0]
        flat = zz.reshape(b, -1)
        per = flat.shape[1]
        padded = -(-per // CHUNK) * CHUNK
        flat = torch.nn.functional.pad(flat, (0, padded - per), value=PAD_SYMBOL)
        chunk_rows.append(flat.reshape(b * (padded // CHUNK), CHUNK))
    sym = torch.cat(chunk_rows, dim=0)
    c_total = sym.shape[0]

    lens, codes = _encode_symbols(sym)
    ends = torch.cumsum(lens, dim=1)
    starts = ends - lens
    total_bits = ends[:, -1]

    # ---- register file: each code's low part lands in word `w`, its high
    # part in word w + 1; codes occupy disjoint bits, so add == or
    sh = starts & 31
    w = starts >> 5
    low = (codes << sh) & _U32
    high = torch.where(sh == 0, torch.zeros_like(codes), codes >> (32 - sh))
    regs = torch.zeros((c_total, REG_WORDS + 1), dtype=torch.int64, device=device)
    regs.scatter_add_(1, w, low)
    regs.scatter_add_(1, w + 1, high)
    regs = regs[:, :REG_WORDS]

    # ---- fixed-slot main stream: a static slice
    main = regs[:, :MAIN_WORDS].reshape(-1)

    # ---- continuation rows, allocated densely in chunk order
    n_slots = default_exc_rows(c_total) if max_exc_rows is None else max_exc_rows
    rows = (-torch.div(MAIN_WORDS * 32 - total_bits, ROW_WORDS * 32, rounding_mode="floor")).clamp(0, MAX_ROWS)
    rank = torch.cumsum(rows, dim=0)  # inclusive (C,)
    slots = torch.arange(n_slots, dtype=torch.int64, device=device)
    # slot -> owning chunk: every chunk scatters its id at its first row
    # slot (max wins, so row-less chunks lose to their successor; ids past
    # the budget land in a dropped extra slot), then a running max fills
    # each owner's row range
    start_excl = rank - rows
    chunk_ids = torch.arange(c_total, dtype=torch.int64, device=device)
    scattered = torch.zeros(n_slots + 1, dtype=torch.int64, device=device)
    scattered.scatter_reduce_(0, start_excl.clamp(max=n_slots), chunk_ids, reduce="amax")
    src = torch.cummax(scattered[:n_slots], dim=0).values
    row_within = slots - start_excl[src]
    tail_width = REG_WORDS - MAIN_WORDS
    flat_tail = regs[:, MAIN_WORDS:].reshape(-1)
    base = src * tail_width + row_within * ROW_WORDS
    idx = base[:, None] + torch.arange(ROW_WORDS, dtype=torch.int64, device=device)[None, :]
    gathered = flat_tail[idx.clamp(0, flat_tail.numel() - 1)]
    valid = slots < rank[-1]
    exc = torch.where(valid[:, None], gathered, torch.zeros_like(gathered)).reshape(-1)

    # ---- per-segment row bases (static boundary indices)
    _, _, bounds = segment_layout([tuple(f.shape) for f in factors])
    rank0 = torch.cat([torch.zeros(1, dtype=torch.int64, device=device), rank])
    seg_row_base = rank0[torch.tensor(bounds, dtype=torch.int64, device=device)].to(torch.int32)
    return seg_row_base, _as_int32_bits(main), _as_int32_bits(exc)


def _inverse_steps():
    """Staircase-inverse decode table: [(L, start_code_msb, first_sym,
    count)] per distinct code length. With canonical monotone codes an
    L-bit MSB-read prefix `c` is a complete code iff `start_L <= c <
    start_L + count_L`, and prefix-freeness makes exactly one length match
    even when the lookahead bits are garbage. The MSB codes come from the
    staircase offsets, `code_msb(zz) = zz + off(zz)`, the encoder's own
    convention (`_monotone_table`)."""
    offs = np.zeros(len(LENS), dtype=np.int64)
    for b, d in _OFF_STEPS:
        offs[b:] += d
    steps = []
    s = 0
    while s < len(LENS):
        length = int(LENS[s])
        e = s
        while e < len(LENS) and int(LENS[e]) == length:
            e += 1
        steps.append((length, int(s + offs[s]), s, e - s))
        s = e
    return steps


_INV_STEPS = _inverse_steps()


def unpack_chunks_device(rows_u8: torch.Tensor, main: torch.Tensor, exc: torch.Tensor, shapes):
    """Decode the dpack upload on its device: the factor values, one int32
    `(B, M, R)` tensor per shape (delta undone).

    Inputs: per-chunk continuation-row counts `(C,)` (any integer dtype),
    the main stream `(C * MAIN_WORDS,)` and the continuation rows
    `(rows * ROW_WORDS,)`, the last two holding uint32 bit patterns in any
    integer dtype (int32 from an upload). Every chunk decodes on its own,
    given its row count, so the batch is CHUNK sequential steps over all
    chunks at once: each step reads a 32-bit window at the chunk's bit
    position, bit-reverses it and matches every code length's MSB prefix
    against `_INV_STEPS`. Values equal `lrf_tpu.ops.entropy.
    unpack_chunks_device`'s; the JAX package selects the window's words by a
    masked sum over all words (lane gathers lower poorly on a TPU), this
    port by `torch.gather`.
    """
    device = main.device
    _, _, bounds = segment_layout(shapes)
    c_total = bounds[-1]
    w_total = MAIN_WORDS + ROW_WORDS * MAX_ROWS
    rows = rows_u8.to(torch.int64)
    base = torch.cumsum(rows, dim=0) - rows
    # per-chunk word window: the fixed main slot, then this chunk's rows and
    # the following chunks' (lookahead bits there never complete a code
    # before this chunk's stream ends; the code is prefix-free), then two
    # zero words where a read runs past the window
    tail_idx = base[:, None] * ROW_WORDS + torch.arange(ROW_WORDS * MAX_ROWS, dtype=torch.int64, device=device)
    tail = exc.to(torch.int64)[tail_idx.clamp(0, exc.numel() - 1)] & _U32
    buf = torch.cat(
        [main.to(torch.int64).reshape(c_total, MAIN_WORDS) & _U32, tail,
         torch.zeros((c_total, 2), dtype=torch.int64, device=device)],
        dim=1,
    )
    lengths = torch.tensor([s[0] for s in _INV_STEPS], dtype=torch.int64, device=device)
    starts = torch.tensor([s[1] for s in _INV_STEPS], dtype=torch.int64, device=device)
    ends = starts + torch.tensor([s[3] for s in _INV_STEPS], dtype=torch.int64, device=device)
    firsts = torch.tensor([s[2] for s in _INV_STEPS], dtype=torch.int64, device=device)
    bitpos = torch.zeros((c_total, 1), dtype=torch.int64, device=device)
    deltas = []
    for _ in range(CHUNK):
        w = (bitpos >> 5).clamp(max=w_total)
        off = bitpos & 31
        w0 = torch.gather(buf, 1, w)
        w1 = torch.gather(buf, 1, w + 1)
        window = ((w0 >> off) | (w1 << (32 - off))) & _U32  # off == 0: w1 shifts out past bit 31
        c = _bit_reverse32(window) >> (32 - lengths)  # (C, steps): each length's MSB prefix
        hit = (c >= starts) & (c < ends)
        sym = torch.sum(torch.where(hit, c - starts + firsts, 0), dim=1, keepdim=True)
        bitpos = bitpos + torch.sum(torch.where(hit, lengths, 0), dim=1, keepdim=True)
        deltas.append(torch.where(sym % 2 == 1, -((sym + 1) // 2), sym // 2))
    deltas = torch.cat(deltas, dim=1)  # (C, CHUNK)

    out = []
    offset = 0
    for b, m, r in shapes:
        per = m * r
        cps = -(-per // CHUNK)
        block = deltas[offset : offset + b * cps].reshape(b, cps * CHUNK)
        offset += b * cps
        out.append(torch.cumsum(block[:, :per].reshape(b, m, r), dim=1).to(torch.int32))
    return out


def decode_segments_py(main: np.ndarray, exc: np.ndarray, seg_row_base: np.ndarray, values_per_segment, seg_ranks):
    """Plain numpy/Python decoder of `pack_segments`' words (uint32 arrays):
    the factor values (delta undone), int32, segments concatenated."""
    max_len = int(LENS.max())
    lut_sym = np.zeros(1 << max_len, np.int32)
    lut_len = np.zeros(1 << max_len, np.int32)
    for s in range(len(LENS)):
        length = int(LENS[s])
        c = int(CODES[s])
        for fill in range(1 << (max_len - length)):
            lut_sym[c | (fill << length)] = s
            lut_len[c | (fill << length)] = length

    main_b = np.ascontiguousarray(main).view(np.uint8)
    exc_b = np.ascontiguousarray(exc).view(np.uint8)
    main_bytes = MAIN_WORDS * 4
    row_bytes = ROW_WORDS * 4
    out = []
    chunk_id = 0
    for s, n_vals in enumerate(values_per_segment):
        row_cursor = int(seg_row_base[s])
        deltas = np.empty(-(-n_vals // CHUNK) * CHUNK, np.int32)
        vi = 0
        while vi < len(deltas):
            buf = bytearray(main_b[chunk_id * main_bytes : (chunk_id + 1) * main_bytes])
            peek = row_cursor  # rows appended for lookahead, not yet consumed
            bitpos = 0
            for _ in range(CHUNK):
                # the decode may peek up to max_len bits past the last code;
                # rows consumed are counted from the final bit position, so
                # peeked rows belong to the next chunk
                while (bitpos + max_len + 7) // 8 + 1 > len(buf):
                    nxt = exc_b[peek * row_bytes : (peek + 1) * row_bytes].tobytes()
                    buf += nxt + b"\0" * (row_bytes - len(nxt))
                    peek += 1
                byte0 = bitpos >> 3
                window = int.from_bytes(buf[byte0 : byte0 + 3], "little") >> (bitpos & 7)
                entry = window & ((1 << max_len) - 1)
                zz = int(lut_sym[entry])
                deltas[vi] = -((zz + 1) // 2) if zz & 1 else zz // 2
                bitpos += int(lut_len[entry])
                vi += 1
            row_cursor += max(0, -(-(bitpos - MAIN_WORDS * 32) // (ROW_WORDS * 32)))
            chunk_id += 1
        vals = deltas[:n_vals].reshape(-1, seg_ranks[s]).cumsum(axis=0, dtype=np.int32)
        out.append(vals.reshape(-1))
    return np.concatenate(out)


def expected_bits_per_value() -> float:
    """Mean code length under the table's own histogram."""
    p = _HIST_ZZ / _HIST_ZZ.sum()
    return float(np.sum(p * LENS))
