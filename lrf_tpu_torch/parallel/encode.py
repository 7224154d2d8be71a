"""Batched QMF encode of same-size images on one device or a device mesh.

Port of `lrf_tpu/parallel/encode.py`. Every entry point takes `device=`:
one device, or a `Mesh` (`parallel/mesh.py`) in place of the JAX mesh. A
`(B, 3, H, W)` batch runs as one batched pipeline: color transform, chroma
downsample, pad, patchify, then the factorization of each channel's
`(B, M, N)` patch stack:

- Cb and Cr share shape and rank at every canonical config, so they are
  merged into ONE `(2B, M, N)` BCD batch;
- `init="svd"` (default): one batched eigh over all channels' `(N, N)`
  Grams initializes every stack (`svd_init_shared`), when every stack is
  tall (M >= N); Grams in float64 rounded once, the eigh on the host's
  LAPACK on every device (`ops/svd.py`); `init="fast"`: the randomized range-finder
  (`ops/svd.py`), one per stack, three K x K eighs in place of the N x N
  one, at a small rate-distortion cost (the opt-in throughput init);
- the BCD loop goes through `lrf_tpu_torch.ops.bcd_kernel.bcd`: the CUDA
  kernel on a GPU, one launch for Y and one for the merged chroma.

On a mesh the batch is split contiguously over the data rows and each
row's images run the pipeline above on the row's device, from a host
thread of its own (`Mesh.map_rows`), the kernel once per stack and row.
With a patch axis > 1 each stack's M rows are split over the row's devices
and factorized by the plain sweeps with their sums over M taken across the
shards (`ops/bcd.py::sharded_bcd`); the fused kernel cannot reduce across
shards inside its loop.

The int8 factors, gathered on the mesh's first device, leave it raw
(`pack=None`, the default), 5-bit packed (`"flat"`), or delta+Huffman
packed (`"entropy"`, `ops/entropy.py`), as one buffer copied to pinned host
memory. The host tail (`_serialize_batch`) turns them into finished streams
in one native call (`native/fibercodec.cpp`: entropy decode, per-fiber
DEFLATE and framing). All modes give the same bytes. On a card with raw
int8 factors and a coder that gives zlib-9 bytes ("zlib" at level 9, or
"best" in a native build without libdeflate, as on a host without it), the
fibers are DEFLATEd on the card instead (`ops/deflate.py`, the same bytes):
the fetch carries the streams and their lengths, and the host only frames
them.
`sharded_qmf_encode_batches` pipelines many batches: device work and copies
stay on the calling thread while two workers serialize earlier batches.
Under a profiler both entry points record the `lrf.encode.*` spans of
`utils/profiling.py`.
"""

from __future__ import annotations

import contextlib
import logging
import math
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from lrf_tpu_torch.models.container import (
    combine_bytes,
    dict_to_bytes,
    encode_matrix_plain,
    encode_tensor_batch,
    get_fiber_coder,
)
from lrf_tpu_torch.models.qmf import _channel_ranks, _padded_size
from lrf_tpu_torch.native import fibercodec as _native
from lrf_tpu_torch.ops import deflate as _deflate
from lrf_tpu_torch.ops import entropy as _entropy
from lrf_tpu_torch.ops.bcd import sharded_bcd, sharded_svd_init, svd_init, svd_init_shared
from lrf_tpu_torch.ops.bcd_kernel import bcd, bcd_reference
from lrf_tpu_torch.ops.color import rgb_to_ycbcr
from lrf_tpu_torch.ops.pad import pad_image
from lrf_tpu_torch.ops.patch import patchify
from lrf_tpu_torch.ops.quantize import torch_dtype
from lrf_tpu_torch.ops.resample import chroma_downsample, scaled_size
from lrf_tpu_torch.parallel.mesh import Mesh, as_mesh
from lrf_tpu_torch.utils import profiling
from lrf_tpu_torch.utils.transfer import HostCopy

__all__ = [
    "EntropyOverflowError",
    "build_sharded_encoder",
    "sharded_qmf_encode_batch",
    "sharded_qmf_encode_batches",
]

# "auto": `bcd` (the CUDA kernel on a GPU, the plain sweeps on the CPU),
# except under patch sharding, where the plain sweeps run across shards;
# "kernel": `bcd` always (refused under patch sharding);
# "torch": the plain PyTorch sweeps on any device (`bcd_reference`).
_BACKENDS = ("auto", "kernel", "torch")
_INITS = ("svd", "fast")

_logger = logging.getLogger("lrf_tpu_torch.parallel")


class EntropyOverflowError(Exception):
    """The entropy pack's continuation-row budget was exceeded for a batch
    (data far from the static code's distribution); callers re-encode that
    batch with the flat pack."""

    def __init__(self, n_ovf: int, budget: int):
        self.n_ovf = n_ovf
        self.budget = budget
        super().__init__(
            f"{n_ovf} continuation rows exceed the {budget}-row budget; falling back to flat packing for this batch"
        )


# Entropy-transport health counters.
ENTROPY_STATS = {"batches": 0, "fallbacks": 0, "max_rows": 0, "budget_bumps": 0, "budget_shrinks": 0}

# Adaptive continuation-row budgets, keyed by the factor-shape tuple. The
# whole budget is copied to the host every batch, so it follows observed
# usage both ways: grown on an overflow or a batch within 5% of it, shrunk
# to a rolling p99 once enough batches were seen. A bump clears the
# history, so the next shrink needs _SHRINK_MIN_OBS fresh batches.
_EXC_ROWS_HINT: dict = {}
_EXC_ROWS_OBS: dict = {}  # shapes-key -> deque of recent observed row counts
_SHRINK_MIN_OBS = 8  # observations before the first shrink
_SHRINK_MARGIN = 1.08  # budget = p99 * margin + 256, rounded up to 1 KiRow


def _observe_entropy_rows(pack_spec, n_rows: int, overflowed: bool) -> None:
    """Update transport stats and the adaptive budget after a batch fetch."""
    ENTROPY_STATS["batches"] += 1
    ENTROPY_STATS["max_rows"] = max(ENTROPY_STATS["max_rows"], n_rows)
    budget = pack_spec["exc_budget"]
    key = pack_spec["shapes"]
    hist = _EXC_ROWS_OBS.setdefault(key, deque(maxlen=64))
    hist.append(n_rows)
    if overflowed:
        ENTROPY_STATS["fallbacks"] += 1
        want = n_rows + (n_rows >> 2) + 64
    elif n_rows * 20 > budget * 19:  # within 5% of the budget
        want = budget + (budget >> 2)
    else:
        want = None
    if want is not None:
        if want > _EXC_ROWS_HINT.get(key, 0):
            _EXC_ROWS_HINT[key] = want
            ENTROPY_STATS["budget_bumps"] += 1
            hist.clear()
            _logger.warning(
                "entropy transport %s: %d continuation rows vs budget %d; next build uses %d (fallbacks so far: %d)",
                "overflow" if overflowed else "near-budget", n_rows, budget, want, ENTROPY_STATS["fallbacks"],
            )
        return
    # Shrink toward observed usage, quantized up to 1024 rows so jitter does
    # not churn it, and only when it saves >= 10%. The target also clears
    # the near-budget trigger for every observed batch, so a shrink never
    # hands the next batch straight back to a bump.
    if len(hist) >= _SHRINK_MIN_OBS:
        arr = np.asarray(hist)
        p99 = float(np.quantile(arr, 0.99))
        target = max(int(p99 * _SHRINK_MARGIN) + 256, int(int(arr.max()) / 0.95) + 1)
        target = -(-target // 1024) * 1024
        if target * 10 <= budget * 9 and _EXC_ROWS_HINT.get(key) != target:
            _EXC_ROWS_HINT[key] = target
            ENTROPY_STATS["budget_shrinks"] += 1
            _logger.info(
                "entropy transport: shrinking continuation-row budget %d -> %d (p99 of %d observed batches: %.0f rows)",
                budget, target, len(hist), p99,
            )


def _pack_params(bounds) -> tuple[int, int]:
    """(lo, bits) for bit-packing factors projected to [ceil(lo), floor(hi)]."""
    lo = math.ceil(bounds[0])
    levels = math.floor(bounds[1]) - lo + 1
    return lo, max(1, math.ceil(math.log2(levels)))


def _pack_factors(factors, lo: int, bits: int) -> torch.Tensor:
    """Bit-pack integer factors into one flat buffer on their device:
    `30 // bits` values per word (value - lo shifted by bits * slot), as
    int32 (words stay below 2^30)."""
    vals_per_word = 30 // bits
    flat = torch.cat([f.reshape(-1).to(torch.int64) - lo for f in factors])
    total = flat.numel()
    n_words = -(-total // vals_per_word)
    flat = torch.nn.functional.pad(flat, (0, n_words * vals_per_word - total))
    shifts = torch.arange(vals_per_word, dtype=torch.int64, device=flat.device) * bits
    return (flat.reshape(n_words, vals_per_word) << shifts).sum(dim=1).to(torch.int32)


def _unpack_factors(packed: np.ndarray, shapes, dtype, lo: int, bits: int):
    """Host inverse of `_pack_factors` on the fetched words."""
    vals_per_word = 30 // bits
    mask = (1 << bits) - 1
    shifts = np.arange(vals_per_word, dtype=np.uint32) * bits
    vals = (packed[:, None] >> shifts[None, :]) & mask
    vals = vals.reshape(-1).astype(np.int32) + lo
    out = []
    offset = 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(vals[offset : offset + n].reshape(shape).astype(dtype))
        offset += n
    return out


class _Deflated(tuple):
    """`deflate_fibers`' `(slots, lens)`, made on the device's side stream
    (`ops/deflate.py::side_stream`), which `_start_fetch` copies them on;
    with the `lrf.encode.deflate` span of their launch (None while nothing
    records), whose `bytes_out` the fetch fills in once the lengths reach
    the host."""

    span = None
    stream = None


def _card_deflate(device: torch.device, dtype, batch, ms) -> bool:
    """Whether a batch's raw factors are DEFLATEd on the card: a CUDA device,
    int8 factors of a known batch, a coder that gives zlib-9 bytes ("zlib"
    at level 9, or "best" in a native build without libdeflate), and fibers
    within the kernel's bound. Read when the encoder is built."""
    if device.type != "cuda" or batch is None or np.dtype(dtype) != np.int8:
        return False
    backend, level = get_fiber_coder()
    if not ((backend == "zlib" and level == 9) or (backend == "best" and "deflate" not in _native.backends())):
        return False
    with torch.cuda.device(device):
        return max(ms) <= _deflate.KERNEL.max_fiber()


def _encoder(mesh, ranks, scale_factor, patch_size, bounds, num_iters, dtype, backend, pack, exc_rows, init):
    """The batched encode function for one config: `(B, 3, H, W)` -> the 6
    factors on the mesh's first device, a 1-tuple holding the packed
    transport buffer, or (pack "zlib9") the card's DEFLATE output."""
    run_bcd = bcd_reference if backend == "torch" else bcd
    method = "randomized" if init == "fast" else "gram"

    def factorize(stacks, stack_ranks, merged):
        """One device: the init, then one BCD run per stack."""
        with profiling.span("lrf.encode.init"):
            if init == "svd" and merged and all(x.shape[-2] >= x.shape[-1] for x in stacks):
                inits = svd_init_shared(stacks, stack_ranks, bounds=bounds)
            else:
                inits = [svd_init(x, r, method=method, bounds=bounds) for x, r in zip(stacks, stack_ranks)]
        with profiling.span("lrf.encode.bcd"):
            return [run_bcd(x, i[0], i[1], num_iters=num_iters, bounds=bounds) for x, i in zip(stacks, inits)]

    def factorize_sharded(stacks, stack_ranks, devices):
        """A data row's patch devices: each stack's M rows split over them,
        the init and the plain sweeps summed across the shards."""
        shards = [[p.to(d, non_blocking=True) for p, d in zip(torch.tensor_split(x, len(devices), dim=1), devices)]
                  for x in stacks]
        with profiling.span("lrf.encode.init"):
            inits = sharded_svd_init(shards, stack_ranks, bounds, method)
        out = []
        with profiling.span("lrf.encode.bcd"):
            for xs, (us, v) in zip(shards, inits):
                us, v = sharded_bcd(xs, us, v, num_iters=num_iters, bounds=bounds)
                out.append((torch.cat([u.to(devices[0], non_blocking=True) for u in us], dim=1), v))
        return out

    def encode_row(images: torch.Tensor, devices):
        with profiling.span("lrf.encode.frontend"):
            channels = chroma_downsample(rgb_to_ycbcr(images), scale_factor)
            stacks = [patchify(pad_image(c, patch_size), patch_size) for c in channels]
        b = stacks[0].shape[0]
        merged = stacks[1].shape == stacks[2].shape and ranks[1] == ranks[2]
        if merged:
            stacks, stack_ranks = [stacks[0], torch.cat(stacks[1:], dim=0)], ranks[:2]
        else:
            stack_ranks = ranks
        if len(devices) > 1:
            per_stack = factorize_sharded(stacks, stack_ranks, devices)
        else:
            per_stack = factorize(stacks, stack_ranks, merged)
        if merged:
            (u_y, v_y), (u_c, v_c) = per_stack
            per_stack = [(u_y, v_y), (u_c[:b], v_c[:b]), (u_c[b:], v_c[b:])]
        return [f.to(dtype) for uv in per_stack for f in uv]

    def encode(images: torch.Tensor):
        if len(mesh.devices) == 1:
            parts = mesh.split_batch(images)
        else:  # each row's part to its row: the batch's upload (`_to_device` leaves it where it is)
            with profiling.span("lrf.encode.upload", bytes_in=images.nbytes):
                parts = mesh.split_batch(images)
        rows = mesh.map_rows(encode_row, parts)
        factors = rows[0] if len(rows) == 1 else [torch.cat([r[k].to(mesh.first) for r in rows]) for k in range(6)]
        if pack == "entropy":
            seg_base, main, exc = _entropy.pack_segments(factors, max_exc_rows=exc_rows)
            return (torch.cat([seg_base, main, exc]),)
        if pack == "flat":
            return (_pack_factors(factors, *_pack_params(bounds)),)
        if pack == "zlib9":
            side = _deflate.side_stream(mesh.first)
            side.wait_stream(torch.cuda.current_stream(mesh.first))
            with torch.cuda.stream(side), profiling.span("lrf.encode.deflate",
                                                         bytes_in=sum(f.nbytes for f in factors)) as s:
                for f in factors:
                    f.record_stream(side)
                out = _Deflated(_deflate.deflate_fibers(factors))
            out.span, out.stream = s, side
            return out
        return tuple(factors)

    return encode


def build_sharded_encoder(
    device,
    image_size: tuple[int, int],
    quality: Optional[float | tuple] = None,
    rank: Optional[int | tuple] = None,
    scale_factor: tuple[float, float] = (0.5, 0.5),
    patch_size: tuple[int, int] = (8, 8),
    bounds: tuple[float, float] = (-16, 15),
    num_iters: int = 10,
    dtype=np.int8,
    backend: str = "auto",
    pack=None,
    batch: Optional[int] = None,
    init: str = "svd",
):
    """A batched YCbCr-patch encoder for one config on `device` (one device
    or a `Mesh`).

    Returns `(encode_fn, metadata, pack_spec)`: `encode_fn(images)` maps a
    `(B, 3, H, W)` tensor (on the device; on a mesh with several data rows,
    anywhere) to the 6 per-channel factor tensors `(B, ., R)` on the mesh's
    first device, or, when a pack mode is active, to a 1-tuple holding the
    packed int32 transport buffer, or, where the card DEFLATEs the fibers
    (raw int8 factors of a known `batch` on a card, under a coder that gives
    zlib-9 bytes: `_card_deflate`), to their zlib streams in fixed slots and
    their lengths, made on the device's side stream: fetch them with
    `_start_fetch`, which copies on that stream, or after synchronizing the
    device; `metadata` is the stream metadata every image shares;
    `pack_spec` (None for raw factors) is what the host needs to reverse
    the pack, or to frame the card's streams (mode "zlib9"). On a mesh B
    must divide evenly over the data rows.

    `pack`: None/False/"" keeps raw factors; "flat" (or True) packs them
    `30 // bits` values per word; "entropy" packs them delta+Huffman
    (`ops/entropy.py`), which needs `batch`, `num_iters >= 1`, int8 and the
    canonical (-16, 15) bounds. Packing needs `batch` (factor shapes carry
    it); without it the factors stay raw. All modes give the same streams.
    `backend`: "auto" (the BCD kernel on a GPU; the plain sweeps across
    shards when the mesh's patch axis is > 1), "kernel" (the BCD kernel
    always; refused under patch sharding) or "torch" (plain sweeps).
    `init`: "svd" (default; the exact shared-eigh init) or "fast" (the
    randomized range-finder per stack; other, near-equal bytes).
    """
    if rank is None and quality is None:
        raise ValueError("Either 'rank' or 'quality' must be specified.")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {_BACKENDS}")
    if init not in _INITS:
        raise ValueError(f"unknown init {init!r}; one of {_INITS}")
    mesh = as_mesh(device)
    if backend == "kernel" and mesh.shape["patch"] > 1:
        raise NotImplementedError(
            "backend='kernel' runs on data-parallel meshes; the fused BCD loop cannot sum over M across patch "
            "shards, so patch-sharded factorization takes the plain sweeps (backend='auto' picks them)"
        )
    size = tuple(image_size)
    patch_size = tuple(patch_size)
    chroma_size = scaled_size(size, scale_factor)
    ch_sizes = (size, chroma_size, chroma_size)
    ranks = _channel_ranks(ch_sizes, rank, quality, True, patch_size)
    padded_sizes = [_padded_size(s, patch_size) for s in ch_sizes]
    metadata = {
        "dtype": "uint8",
        "color space": "YCbCr",
        "patch": True,
        "bounds": list(bounds),
        "patch size": list(patch_size),
        "original size": [list(s) for s in ch_sizes],
        "padded size": padded_sizes,
        "rank": list(ranks),
    }
    lo, bits = _pack_params(bounds)
    if pack is True:
        pack = "flat"
    pack = pack or ""
    if pack not in ("", "flat", "entropy"):
        raise ValueError(f"unknown pack {pack!r}; one of None, 'flat', 'entropy'")
    entropy_ok = batch is not None and num_iters >= 1 and (lo, bits) == (-16, 5) and np.dtype(dtype) == np.int8
    if pack == "entropy" and not entropy_ok:
        raise ValueError("pack='entropy' needs batch, num_iters >= 1, int8 and the canonical (-16, 15) bounds")
    if batch is None:
        pack = ""

    pack_spec = None
    exc_budget = None
    p, q = patch_size
    shapes = []
    for padded, r in zip(padded_sizes, ranks):
        shapes.append((batch, (padded[0] // p) * (padded[1] // q), r))  # u
        shapes.append((batch, p * q, r))  # v
    shapes = tuple(shapes)
    if not pack and _card_deflate(mesh.first, dtype, batch, [s[1] for s in shapes]):
        pack = "zlib9"
        pack_spec = {"mode": pack, "shapes": shapes, "caps": tuple(_deflate.slot_caps([s[1] for s in shapes]))}
    elif pack:
        pack_spec = {"mode": pack, "shapes": shapes, "lo": lo, "bits": bits, "dtype": np.dtype(dtype)}
        if pack == "entropy":
            values, _, bounds_idx = _entropy.segment_layout(shapes)
            c_total = bounds_idx[-1]
            exc_budget = _EXC_ROWS_HINT.get(shapes) or _entropy.default_exc_rows(c_total)
            pack_spec.update(
                values_per_segment=tuple(values),
                n_seg_words=len(values) + 1,
                main_words=c_total * _entropy.MAIN_WORDS,
                exc_budget=exc_budget,
            )
    fn = _encoder(
        mesh, ranks, tuple(scale_factor), patch_size, tuple(bounds), num_iters, torch_dtype(dtype), backend, pack,
        exc_budget, init,
    )
    return fn, metadata, pack_spec


def _to_device(images, mesh: Mesh) -> torch.Tensor:
    """The batch as a tensor: on the device of a one-row mesh, else where it
    is (`Mesh.split_batch` moves each row's part to its row)."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images))
    if len(mesh.devices) > 1:
        return images
    with profiling.span("lrf.encode.upload", bytes_in=images.nbytes):
        return images.to(mesh.first)


def _start_fetch(out) -> HostCopy:
    """The encoder's output on its way to pinned host memory, on the stream
    that made it."""
    stream = getattr(out, "stream", None)
    with profiling.span("lrf.encode.fetch_start", bytes_in=sum(t.nbytes for t in out)), (
        torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
    ):
        copy = HostCopy(out)
    copy.deflate_span = getattr(out, "span", None)
    return copy


def _fetch_encoded(copy: HostCopy, pack_spec):
    """Wait for a fetch and lay it out for `_serialize_batch`: the 6 factor
    arrays (raw), the packed words (flat), `(seg_base, main, exc)` with
    only the used continuation rows (entropy), or the card's `(slots,
    lens)` (zlib9). Raises EntropyOverflowError when the entropy pack ran
    out of rows."""
    with profiling.span("lrf.encode.fetch_wait", mirror=True):
        host = copy.wait()
    if pack_spec is None:
        return host
    if pack_spec["mode"] == "zlib9":
        span = getattr(copy, "deflate_span", None)
        if span is not None:
            span.bytes_out = int(host[1].sum(dtype=np.int64))
        return host
    flat = host[0].view(np.uint32)
    if pack_spec["mode"] != "entropy":
        return flat
    n_seg = pack_spec["n_seg_words"]
    seg_base = flat[:n_seg].astype(np.int32)
    n_rows = int(seg_base[-1])
    overflowed = n_rows > pack_spec["exc_budget"]
    _observe_entropy_rows(pack_spec, n_rows, overflowed)
    if overflowed:
        raise EntropyOverflowError(n_rows, pack_spec["exc_budget"])
    main_end = n_seg + pack_spec["main_words"]
    return seg_base, flat[n_seg:main_end], flat[main_end : main_end + n_rows * _entropy.ROW_WORDS]


def _decode_entropy(host_out, pack_spec):
    """The fetched `(seg_base, main, exc)` entropy buffers -> the int8
    factor arrays (native decoder)."""
    seg_base, main, exc = host_out
    shapes = pack_spec["shapes"]
    flat = _native.dpack_decode_segments(
        main, exc, seg_base, pack_spec["values_per_segment"], _entropy.segment_ranks(shapes), _entropy.LENS,
        _entropy.CODES, _entropy.CHUNK, _entropy.MAIN_WORDS, _entropy.ROW_WORDS,
    )
    factors = []
    offset = 0
    for shape in shapes:
        n = int(np.prod(shape))
        factors.append(flat[offset : offset + n].reshape(shape).astype(pack_spec["dtype"]))
        offset += n
    return factors


def _inner_metadata(rs) -> list[bytes]:
    return [dict_to_bytes({"num_fibers": int(r), "mode": "col", "dtype": "int8"}) for r in rs]


def _serialize_batch(host_out, pack_spec, metadata, b: int) -> list[bytes]:
    """Host tail of batch encoding: fetched buffers -> per-image streams.

    Takes numpy buffers only, never tensors, so it runs on a worker thread
    beside device work on the calling thread. Int8 factors, whatever the
    transport, take one native call that does the whole stream assembly
    (entropy decode, per-fiber DEFLATE with the process-wide coder, inner
    metadata, framing); the card's zlib streams take one that frames them;
    other dtypes go through the container per factor.
    """
    backend, level = get_fiber_coder()
    encoded_metadata = dict_to_bytes(metadata)
    if pack_spec is not None and pack_spec["mode"] == "zlib9":
        slots, lens = host_out
        rs = [s[2] for s in pack_spec["shapes"]]
        return _native.frame_streams(slots, lens, b, rs, pack_spec["caps"], encoded_metadata, _inner_metadata(rs))
    if pack_spec is not None and pack_spec["mode"] == "entropy":
        seg_base, main, exc = host_out
        rs = [s[2] for s in pack_spec["shapes"]]
        return _native.dpack_assemble_streams(
            main, exc, seg_base.astype(np.int64), b, [s[1] for s in pack_spec["shapes"]], rs, _entropy.LENS,
            _entropy.CODES, _entropy.CHUNK, _entropy.MAIN_WORDS, _entropy.ROW_WORDS, encoded_metadata,
            _inner_metadata(rs), level, backend,
        )
    if pack_spec is not None:
        host_out = _unpack_factors(host_out, pack_spec["shapes"], pack_spec["dtype"], pack_spec["lo"], pack_spec["bits"])
    if all(f.dtype == np.int8 and f.ndim == 3 for f in host_out):
        rs = [f.shape[2] for f in host_out]
        return _native.assemble_streams(
            host_out, b, [f.shape[1] for f in host_out], rs, encoded_metadata, _inner_metadata(rs), level, backend
        )
    per_factor_blobs = [encode_tensor_batch(f) for f in host_out]
    return [
        combine_bytes([encoded_metadata, combine_bytes([blobs[i] for blobs in per_factor_blobs])]) for i in range(b)
    ]


def _serialize_spanned(host_out, pack_spec, metadata, b: int, parent=None, submitted_ns=None) -> list[bytes]:
    """`_serialize_batch` under the `lrf.encode.serialize` span, after the
    `lrf.encode.serializer_queue` span from `submitted_ns` when it waited
    in a worker pool's queue; `parent` is the submitting batch's span."""
    if submitted_ns is not None:
        profiling.record("lrf.encode.serializer_queue", submitted_ns, parent=parent)
    nbytes = sum(a.nbytes for a in host_out) if isinstance(host_out, (list, tuple)) else host_out.nbytes
    with profiling.span("lrf.encode.serialize", parent=parent, bytes_in=nbytes) as s:
        streams = _serialize_batch(host_out, pack_spec, metadata, b)
        if s is not None:
            s.bytes_out = sum(len(x) for x in streams)
    return streams


def _serialize_plain(host_factors, metadata, b: int, level: int = 9) -> list[bytes]:
    """Plain version of `_serialize_batch` on raw `(B, M, R)` factors: one
    CPython `zlib.compress` per fiber and Python framing. Its bytes equal
    `_serialize_batch`'s under the "zlib" coder at the same level."""
    encoded_metadata = dict_to_bytes(metadata)
    per_factor = [[encode_matrix_plain(f[i], "col", level) for i in range(b)] for f in host_factors]
    return [combine_bytes([encoded_metadata, combine_bytes([blobs[i] for blobs in per_factor])]) for i in range(b)]


def sharded_qmf_encode_batch(
    images,
    device="cuda",
    quality: Optional[float | tuple] = None,
    rank: Optional[int | tuple] = None,
    **config,
) -> list[bytes]:
    """Encode a `(B, 3, H, W)` uint8 batch into per-image QMF byte streams.

    On the CPU the streams are byte-identical to per-image
    `lrf_tpu_torch.qmf_encode`. On a GPU the BCD kernel sums in another
    order than the plain sweeps, so a small share of factor entries can
    differ at round() ties; every stream decodes with either package. A
    batch that overflows the entropy pack's row budget is re-encoded with
    the flat pack (same bytes). `device` may be a `Mesh`: on the CPU a data
    mesh gives the one device's bytes, and a patch-sharded one near-equal
    streams (the sums over M are split). The arguments are in the JAX
    package's order, `(images, mesh, quality, rank, **config)`.
    """
    mesh = as_mesh(device)
    profiling.follow_profiler()
    root = profiling.begin("lrf.encode.batch", batch=0)
    try:
        with profiling.within(root):
            images = _to_device(images, mesh)
            b = int(images.shape[0])
            size = (int(images.shape[-2]), int(images.shape[-1]))
            fn, metadata, pack_spec = build_sharded_encoder(mesh, size, quality=quality, rank=rank, batch=b, **config)
            try:
                host_out = _fetch_encoded(_start_fetch(fn(images)), pack_spec)
            except EntropyOverflowError:
                return sharded_qmf_encode_batch(images, device=mesh, quality=quality, rank=rank,
                                                **{**config, "pack": "flat"})
            return _serialize_spanned(host_out, pack_spec, metadata, b)
    finally:
        profiling.end(root)


def sharded_qmf_encode_batches(
    batches,
    device="cuda",
    quality: Optional[float | tuple] = None,
    rank: Optional[int | tuple] = None,
    depth: int = 3,
    **config,
):
    """Pipelined encode of a sequence of `(B, 3, H, W)` batches.

    Generator yielding `list[bytes]` per input batch, in order. Each batch's
    encode is dispatched and its device -> pinned-host copy started on the
    calling thread, up to `depth` batches ahead of the fetch; fetched
    buffers go to two serializer workers (native, GIL-released C++), so
    device work, copies and host DEFLATE overlap. The serializer workers
    touch only numpy and the native library, never torch. The one
    exception to keeping torch calls on the calling thread is a mesh with
    several data rows: the encoder dispatches each row from a thread of its
    own (`Mesh.map_rows`) and joins them before it returns. A batch that
    overflows the entropy row budget is re-encoded with the flat pack.
    Streams equal `sharded_qmf_encode_batch`'s. The arguments are in the
    JAX package's order: `(batches, mesh, quality, rank, depth)`.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    mesh = as_mesh(device)
    profiling.follow_profiler()
    with ThreadPoolExecutor(max_workers=2) as pool:
        in_flight = deque()  # (copy, pack_spec, metadata, b, images, root span)
        pending = deque()  # (future of list[bytes], root span), in batch order

        def drain_one():
            copy, pack_spec, metadata, b, images, root = in_flight.popleft()
            with profiling.within(root):
                try:
                    host_out = _fetch_encoded(copy, pack_spec)
                except EntropyOverflowError:
                    size = (int(images.shape[-2]), int(images.shape[-1]))
                    fn, metadata, pack_spec = build_sharded_encoder(
                        mesh, size, quality=quality, rank=rank, batch=b, **{**config, "pack": "flat"}
                    )
                    host_out = _fetch_encoded(_start_fetch(fn(images)), pack_spec)
            fut = pool.submit(_serialize_spanned, host_out, pack_spec, metadata, b, root, time.perf_counter_ns())
            profiling.end(root)
            pending.append((fut, root))

        def result():
            profiling.follow_profiler()
            fut, root = pending.popleft()
            with profiling.span("lrf.encode.result_wait", parent=root, mirror=True):
                return fut.result()

        for seq, images in enumerate(batches):
            profiling.follow_profiler()
            root = profiling.begin("lrf.encode.batch", batch=seq)
            with profiling.within(root):
                images = _to_device(images, mesh)
                b = int(images.shape[0])
                size = (int(images.shape[-2]), int(images.shape[-1]))
                fn, metadata, pack_spec = build_sharded_encoder(
                    mesh, size, quality=quality, rank=rank, batch=b, **config
                )
                in_flight.append((_start_fetch(fn(images)), pack_spec, metadata, b, images, root))
            if len(in_flight) > depth:
                drain_one()
            while len(pending) > 2:
                yield result()
        while in_flight:
            drain_one()
        while pending:
            yield result()
